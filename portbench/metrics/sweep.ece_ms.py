"""Device ms per batch of the per-weather ECE bins (span ``sweep.ece`` in
``Evaluator.accumulate``)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'sweep.ece')
