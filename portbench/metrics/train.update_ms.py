"""Device ms per step of AdamW's update (span ``train.update`` in
``Optimizer.step``)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'train.update')
