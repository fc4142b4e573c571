"""Device ms per step of the fog-density-aware loss (span ``train.loss`` in
``trainer.train_step``)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'train.loss')
