"""Device selection for the port's entry points, and constant tables on it."""

from __future__ import annotations

from typing import Callable

import torch

_CONSTS: dict[tuple, torch.Tensor] = {}


def resolve_device(device: str | torch.device = 'cuda') -> torch.device:
    """The torch device for ``device``; raises when a CUDA device is asked
    for and no card is present (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def const(make: Callable, *args, device: torch.device,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``make(*args)`` (numpy or a sequence) as a tensor on ``device``,
    copied there once and reused. A fresh host-to-device copy of a small
    table on every call would make the host wait for the card each time."""
    key = (make, args, torch.device(device), dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(make(*args), dtype=dtype,
                                           device=device)
    return t
