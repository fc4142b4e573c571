"""Device ms per batch of the sweep's preparation (span ``sweep.prepare`` in
``Evaluator.run``: copies to the device, padded rows and draws, corruption
with K3, normalisation, the cast to the compute dtype)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'sweep.prepare')
