"""Tracing, phase timers and throughput (counterpart of
``awsegbench/utils/profiling.py``): an optional ``torch.profiler`` trace
scope, per-phase wall timers, an images/s meter that waits for the device
once when it stops, and a NaN-check switch."""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

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


class PhaseTimers:
    """Accumulating named wall-clock timers (data/compute/metrics phases)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {'total_s': self.totals[name],
                       'count': self.counts[name],
                       'mean_s': self.totals[name] / max(self.counts[name], 1)}
                for name in self.totals}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


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
