"""Device ms per batch of the per-weather confusion matrices (span
``sweep.confusion`` in ``Evaluator.accumulate``)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'sweep.confusion')
