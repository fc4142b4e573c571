"""Tracing and throughput (counterpart of ``awsegbench/utils/profiling.py``):
an optional ``torch.profiler`` trace scope, the named spans the sweep and
the train step open at their layer boundaries, an images/s meter that
waits for the device once when it stops, and a NaN-check switch.

The JAX package's ``PhaseTimers`` (wall-clock phase timers) has no
counterpart: a span times a phase on the profiler's clock, beside the
device's work."""

from __future__ import annotations

import contextlib
import logging
import time
from typing import ContextManager, Iterable, Iterator, Optional, TypeVar

import torch
from torch.profiler import record_function

logger = logging.getLogger(__name__)


def enable_nan_checks(enabled: bool = True) -> None:
    """Turn autograd's anomaly detection on (``debug.nan_checks``): a
    backward that makes a NaN raises, naming the forward op."""
    torch.autograd.set_detect_anomaly(enabled)


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host and, on a card, device)
    into ``profile_dir`` when it is set."""
    if not profile_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(profile_dir))):
        yield
    logger.info(f"Profiler trace written to {profile_dir}")


_NO_SPAN = contextlib.nullcontext()
_END = object()
T = TypeVar('T')


def span(name: str) -> ContextManager:
    """``with span(name):`` marks the block on the host as the span
    ``name`` in a ``torch.profiler`` trace (a ``record_function``: a
    ``user_annotation`` event on the clock the device's intervals are
    aligned to). With no profiler recording it is a shared context that
    does nothing, at the cost of one flag check."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return record_function(name)


def spanned(items: Iterable[T], name: str) -> Iterator[T]:
    """``items``, each ``next()`` on them inside the span ``name``: the
    wait for a loader's next batch."""
    it = iter(items)
    while True:
        with span(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


class ThroughputMeter:
    """images/s over the wall time from ``start`` to ``stop``."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._n = 0
        self._t0: Optional[float] = None
        self._elapsed = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def update(self, n_images: int) -> None:
        if self._t0 is None:
            self.start()
        self._n += n_images

    def stop(self, sync_on: Optional[torch.Tensor] = None) -> None:
        """Stop timing; given a tensor on a card, wait for that card first
        (one synchronisation) so the time covers the work queued on it."""
        if sync_on is not None and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        if self._t0 is not None:
            self._elapsed += time.perf_counter() - self._t0
            self._t0 = None

    @property
    def images_per_sec(self) -> float:
        return self._n / self._elapsed if self._elapsed > 0 else 0.0

    @property
    def total_images(self) -> int:
        return self._n
