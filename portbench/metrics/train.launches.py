"""Device operations launched per train step (span ``train.step``: the
whole ``TrainStep.__call__``, autograd's launches included)."""

from portbench.common.spans import ops_per_call


def read(ctx):
    return ops_per_call(ctx, 'train.step')
