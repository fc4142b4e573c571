"""Device operations launched per batch of the sweep (span ``sweep.batch``
in ``Evaluator.run``)."""

from portbench.common.spans import ops_per_call


def read(ctx):
    return ops_per_call(ctx, 'sweep.batch')
