"""What a span of the program costs the host: its host milliseconds per
call and the device operations launched inside it per call. Reads only
``Trace``'s public ``spans``, ``ops``, ``launch`` and ``span_ops``;
returns None where the span never opened (a program without it).

Neither reading rests on the device's timestamps: host ms comes from the
host's spans, and an operation counts for the span open on the host when
it was launched. Both also say on standard error where the trace's device
records do not line up with the host's (:func:`unsound`), since the device
ms read from such a trace are off. They do not fail the run: the
profiler's fault hits a program without the spans alike."""

from __future__ import annotations

import statistics
import sys
from typing import Any, Mapping

# how far a device op may seem to start before the host call that launched
# it: sound traces drift by up to 0.03 ms over a window of 1.1-3.1 s, and
# 1 ms moves every device reading by under 0.1%
LEAD_S = 1e-3
# a call of a span launching under this share of the median call's
# operations has lost device records
SHORT = 0.9


def _launched(trace, name: str) -> list[int]:
    """The device operations launched inside each span ``name``."""
    return [len(ops) for ops in trace.span_ops(name)]


def unsound(trace, counts: list[int]) -> str | None:
    """Why the trace's device records do not line up with the host's, or
    None: a device op starts more than ``LEAD_S`` before its launch on the
    host (the device's timestamps are scaled against the host's), or a call
    of a span that repeats once an iteration launched under ``SHORT`` of
    the median call's operations (``counts``, one a call: records were
    lost)."""
    lead = max((trace.launch[corr] - s for _, s, _, corr in trace.ops
                if corr in trace.launch), default=0.0)
    if lead > LEAD_S:
        return (f'a device op starts {lead * 1e3:.3f} ms before its launch '
                'on the host: the device timestamps are not aligned with '
                'the host clock')
    if counts and min(counts) < SHORT * statistics.median(counts):
        return (f'a call launched {min(counts)} device ops against a median '
                f'of {statistics.median(counts)}: device records were lost')
    return None


def _note(trace, counts: list[int]) -> None:
    why = unsound(trace, counts)
    if why is not None:
        print(f'portbench: unsound trace, device ms are off: {why}',
              file=sys.stderr)


def host_ms(ctx: Mapping[str, Any], name: str) -> float | None:
    """The mean host duration of the span ``name`` (once an iteration), in
    ms."""
    spans = sorted(ctx['trace'].span_intervals(name))
    if not spans:
        return None
    _note(ctx['trace'], _launched(ctx['trace'], name))
    return sum(e - s for s, e in spans) / len(spans) * 1e3


def ops_per_call(ctx: Mapping[str, Any], name: str) -> float | None:
    """The device operations (kernels, copies, sets) whose launch falls
    inside the span ``name`` (once an iteration) on the host, per call of
    it."""
    counts = _launched(ctx['trace'], name)
    if not counts:
        return None
    _note(ctx['trace'], counts)
    return sum(counts) / len(counts)
