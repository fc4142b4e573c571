"""Device ms per batch of the sweep's metrics (``Evaluator.accumulate``)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'sweep.accumulate')
