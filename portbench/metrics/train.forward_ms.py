"""Device ms per step of the train-mode forward and its outputs' cast to f32
(span ``train.forward`` in ``trainer.train_step``)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'train.forward')
