"""Bilinear upsampling of NHWC tensors (a frozen copy of the port's
``ops/resize.py``): ``F.interpolate(mode='bilinear',
align_corners=False)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample of NHWC ``x`` to (H, W) = ``out_hw``."""
    if x.ndim != 4:
        raise ValueError(f"resize_bilinear: expected NHWC, got ndim {x.ndim}")
    h, w = out_hw
    if h < x.shape[1] or w < x.shape[2]:
        raise ValueError("resize_bilinear: downsampling would need "
                         "jax.image.resize's antialiasing: use resize_linear")
    if (h, w) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode='bilinear',
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def upsample_like(x: torch.Tensor, ref_hw: tuple[int, int]) -> torch.Tensor:
    """F.interpolate(..., size=ref_hw, mode='bilinear', align_corners=False)
    on NHWC ``x``."""
    return resize_bilinear(x, ref_hw)
