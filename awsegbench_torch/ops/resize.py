"""Resize (counterpart of ``awsegbench/ops/resize.py``), on NHWC, HWC or
HW tensors.

* Bilinear: ``jax.image.resize(method='linear')`` samples at half-pixel
  centres and clamps at the edges when it upsamples, which is exactly
  ``F.interpolate(mode='bilinear', align_corners=False)``:
  :func:`resize_bilinear`, the models' path, which refuses to shrink.
  When an axis shrinks JAX antialiases: a triangle filter widened by the
  scale, each output's weights normalised to sum to 1.
  :func:`resize_linear` takes any sizes by JAX's weight matrix
  (``_linear_weights``, the same f32 arithmetic) along each resized axis.
* Nearest: ``jax.image.resize(method='nearest')`` also samples at
  half-pixel centres, ``floor((i + 0.5)·in/out)`` in f32: that is
  ``F.interpolate(mode='nearest-exact')``, not ``mode='nearest'``. It is
  computed here as an index gather with JAX's own f32 indices, so any
  dtype (integer labels too) passes through unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import const


def _linear_weights(m: int, n: int) -> np.ndarray:
    """JAX's antialiased linear weight matrix [m, n] for an axis of m
    samples resized to n (``jax._src.image.scale.compute_weight_mat``)."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.0) - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=np.float32)[:, None]) \
        / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


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


def resize_linear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., method='linear')`` of float NHWC, HWC or
    HW ``x`` to (H, W) = ``out_hw``, up or down (antialiased where an axis
    shrinks): JAX's weight matrix applied along each resized axis."""
    if x.ndim not in (2, 3, 4):
        raise ValueError(f"resize_linear: unsupported ndim {x.ndim}")
    axes = (1, 2) if x.ndim == 4 else (0, 1)
    for axis, n in zip(axes, out_hw):
        m = x.shape[axis]
        if m != n:
            wm = const(_linear_weights, m, n, device=x.device, dtype=x.dtype)
            x = torch.movedim(torch.tensordot(x, wm, dims=([axis], [0])), -1,
                              axis)
    return x


def _nearest_index(m: int, n: int) -> np.ndarray:
    """JAX's nearest source index for each of n outputs from m inputs."""
    f32 = np.float32
    return np.floor((np.arange(n, dtype=f32) + f32(0.5)) * f32(m) / f32(n)
                    ).astype(np.int64)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize (labels) of NHWC, HWC or HW ``x`` to (H, W)
    = ``out_hw`` (as in the JAX package, a 3-D tensor is HWC: its first two
    axes are resized). Any dtype; values are copied, never computed."""
    if x.ndim not in (2, 3, 4):
        raise ValueError(f"resize_nearest: unsupported ndim {x.ndim}")
    axes = (1, 2) if x.ndim == 4 else (0, 1)
    for axis, n in zip(axes, out_hw):
        m = x.shape[axis]
        if m != n:
            x = x.index_select(axis, const(_nearest_index, m, n,
                                           device=x.device, dtype=torch.long))
    return x


def upsample_like(x: torch.Tensor, ref_hw: tuple[int, int]) -> torch.Tensor:
    """F.interpolate(..., size=ref_hw, mode='bilinear', align_corners=False)
    on NHWC ``x``."""
    return resize_bilinear(x, ref_hw)
