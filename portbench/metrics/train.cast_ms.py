"""Device ms per step of the parameters' cast to the compute dtype (span
``train.cast`` in ``trainer.train_step``)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'train.cast')
