"""Host ms per train step (span ``train.step``: the whole
``TrainStep.__call__``). Read from the traced run, so it includes the
profiler's own host cost for every operation it records: compare it only
with other traced runs, beside ``train.launches``, and never cite its fall
alone as a gain (fewer launches lower it by the profiler's cost too)."""

from portbench.common.spans import host_ms


def read(ctx):
    return host_ms(ctx, 'train.step')
