"""Device ms per step of the backward (span ``train.backward`` in
``trainer.train_step``; autograd's launches fall inside it by time)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'train.backward')
