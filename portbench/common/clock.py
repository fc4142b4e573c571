"""Seconds of each stage of a run's set-up and check, as notes for its
standard error."""

from __future__ import annotations

import time
from typing import Callable


class Clock:
    """``clock(label)`` notes the seconds since the last call (after
    ``sync()``)."""

    def __init__(self, notes: list[str], sync: Callable[[], None]) -> None:
        self.notes, self.sync = notes, sync
        self.t = time.perf_counter()

    def __call__(self, label: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.notes.append(f'{label}: {now - self.t!r} s')
        self.t = now
