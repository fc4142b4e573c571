"""Spans around calls into the port, and the reading of a profiler trace.

A span is ``torch.profiler.record_function`` around a bound method, set on
the instance by the benchmark (:func:`span`); nothing in the port is
edited. A traced window runs under ``torch.profiler.profile`` (CPU and
CUDA activities); its Chrome trace is read back (:class:`Trace`): every
device operation (kernels, copies, sets) with its interval, the host call
that launched it (by correlation id) and every span's host interval.

A span's device time is the union of the intervals of the device
operations launched while it was open on the host, so streams that overlap
are not counted twice. The device's busy time is the union of all device
intervals inside the window; its idle share is one less busy over the
window. This replaces ``chip_smoke.py:1376`` (``profile_step``), whose
busy time was a sum of kernel durations over one call.
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import tempfile
from typing import Callable

WINDOW = 'portbench.window'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')


def span(name: str, fn: Callable) -> Callable:
    """``fn`` inside ``record_function(name)``."""
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def set_span(obj, attr: str, name: str) -> None:
    """Wraps ``obj.attr`` (a bound method) in the span ``name``, on the
    instance."""
    setattr(obj, attr, span(name, getattr(obj, attr)))


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, merged and sorted."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


class Trace:
    """A Chrome trace's device operations and spans, in seconds."""

    def __init__(self, events: list[dict]) -> None:
        launch = {}
        self.ops: list[tuple[str, float, float, int | None]] = []
        self.spans: list[tuple[str, float, float]] = []
        for e in events:
            if e.get('ph') != 'X':
                continue
            cat = e.get('cat', '')
            ts, dur = float(e['ts']) * 1e-6, float(e.get('dur', 0)) * 1e-6
            corr = (e.get('args') or {}).get('correlation')
            if cat in DEVICE_CATS:
                self.ops.append((e['name'], ts, ts + dur, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launch[corr] = ts
            elif cat == 'user_annotation':
                self.spans.append((e['name'], ts, ts + dur))
        self.launch = launch
        windows = [(s, e) for n, s, e in self.spans if n == WINDOW]
        if not windows:
            raise ValueError('the trace has no window span')
        self.t0, self.t1 = windows[0]
        self.ops = sorted(o for o in self.ops
                          if o[2] > self.t0 and o[1] < self.t1)

    @classmethod
    def from_profile(cls, prof) -> 'Trace':
        """Exports ``prof``'s Chrome trace to a temporary file, reads it and
        deletes it."""
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return cls(data['traceEvents'] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list[tuple[float, float]]:
        return clip(union([(s, e) for _, s, e, _ in self.ops]), self.t0,
                    self.t1)

    @property
    def busy_s(self) -> float:
        return length(self.busy())

    def ops_named(self, pred: Callable[[str], bool]):
        return [o for o in self.ops if pred(o[0])]

    def span_intervals(self, name: str) -> list[tuple[float, float]]:
        return [(s, e) for n, s, e in self.spans if n == name]

    def span_ops(self, name: str) -> list[list[tuple]]:
        """For each span ``name``, in order of its start, the device
        operations launched on the host while it was open (the latest span
        to open before the launch, if it had not closed yet)."""
        spans = sorted(self.span_intervals(name))
        starts = [s for s, _ in spans]
        inside: list[list[tuple]] = [[] for _ in spans]
        for op in self.ops:
            t = self.launch.get(op[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                inside[i].append(op)
        return inside

    def span_device(self, name: str) -> tuple[float, int]:
        """(device seconds of the operations launched inside the spans
        ``name``, the number of those spans)."""
        per_span = self.span_ops(name)
        return (length(union([(s, e) for ops in per_span
                              for _, s, e, _ in ops])), len(per_span))

    def label_at(self, t: float) -> str:
        """The innermost span (other than the window) open on the host at
        ``t``, or 'window'."""
        best = None
        for n, s, e in self.spans:
            if n != WINDOW and s <= t <= e and (best is None
                                                 or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best[2] if best else 'window'

    def breakdown(self, top: int = 10) -> dict[str, list]:
        """The device operations that took most time (by name, summed) and
        the longest idle gaps inside the window, each labelled by the span
        open on the host at its middle."""
        by_name: dict[str, float] = {}
        for name, s, e, _ in self.ops:
            key = name[:160]
            by_name[key] = by_name.get(key, 0.0) + (min(e, self.t1)
                                                   - max(s, self.t0))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {'device_ops': [[n, s] for n, s in ops],
                'idle_gaps': [[self.label_at((s + e) / 2), e - s]
                              for s, e in gaps]}
