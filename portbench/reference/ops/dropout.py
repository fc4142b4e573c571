"""The counter-hash dropout mask of the heads (a frozen copy of the plain
mask of ``awsegbench_torch/ops/headkernels_train.py``): keep element
``(y·W + x)·C + c`` of image b iff ``mix32(idx ^ image_seed) ≥
round(rate·2³²)``, in uint32 arithmetic held in int64."""

from __future__ import annotations

import torch

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_U32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h·m) mod 2³² for h in [0, 2³²), the halves of m multiplied apart."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """lowbias32 on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 15)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def image_seed(seed: torch.Tensor, b: int) -> torch.Tensor:
    """Image b's seed, ``seed ^ mix32(b·M1)``."""
    s = seed.reshape(-1).to(torch.int64)[0] & _U32
    return s ^ _mix32(_mul32(torch.tensor(b, dtype=torch.int64,
                                          device=seed.device) & _U32, _M1))


def dropout_keep_mask(shape, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """[B, H, W, C] bool keep mask on the seed's device."""
    B, H, W, C = shape
    dev = seed.device
    thresh = min(int(round(rate * 4294967296.0)), 4294967295)
    idx = ((torch.arange(H, dtype=torch.int64, device=dev)[:, None, None] * W
            + torch.arange(W, dtype=torch.int64, device=dev)[None, :, None])
           * C + torch.arange(C, dtype=torch.int64, device=dev))
    return torch.stack([_mix32(idx ^ image_seed(seed, b)) >= thresh
                        for b in range(B)])
