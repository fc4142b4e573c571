"""Host ms per batch of the sweep (span ``sweep.batch`` in ``Evaluator.run``:
from the host batch in hand to ``accumulate``'s end). Read from the traced
run, so it includes the profiler's own host cost for every operation it
records: compare it only with other traced runs, beside ``sweep.launches``,
and never cite its fall alone as a gain (fewer launches lower it by the
profiler's cost too)."""

from portbench.common.spans import host_ms


def read(ctx):
    return host_ms(ctx, 'sweep.batch')
