"""Device ms per step of the global-norm clip (span ``train.clip`` in
``Optimizer.step``)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'train.clip')
