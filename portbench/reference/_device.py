"""Constant tables on a device, made once (a frozen copy of
``awsegbench_torch/_device.py::const``)."""

from __future__ import annotations

from typing import Callable

import torch

_CONSTS: dict[tuple, torch.Tensor] = {}


def const(make: Callable, *args, device: torch.device,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``make(*args)`` (numpy or a sequence) as a tensor on ``device``,
    made once and reused, outside inference mode."""
    key = (make, args, torch.device(device), dtype)
    t = _CONSTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTS[key] = torch.as_tensor(make(*args), dtype=dtype,
                                               device=device)
    return t
