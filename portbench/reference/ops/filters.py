"""Image filters on NHWC batches (a frozen copy of the port's
``ops/filters.py``).

Borders, the parity trap of this module:

* OpenCV's default BORDER_REFLECT_101 (``cv2.GaussianBlur``,
  ``cv2.Laplacian``) mirrors about the edge pixel: ``dcb|abcd|cba``.
  That is numpy's ``'reflect'`` and ``F.pad(mode='reflect')``.
* ``scipy.ndimage``'s default ``mode='reflect'`` repeats the edge pixel:
  ``cba|abcd|dcb``. That is numpy's ``'symmetric'``; ``F.pad`` has no such
  mode.

Both are built here by one index gather along the filtered axis, so one
code path serves the two modes. The 1-D passes are shifted multiply-adds
in the JAX package's order (tap 0 first), which keeps the sums rounded as
the reference rounds them.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from .._device import const

BoundaryMode = Literal['reflect', 'symmetric']


def gaussian_kernel1d_scipy(sigma: float, radius: int | None = None) -> np.ndarray:
    """Gaussian taps identical to scipy.ndimage._gaussian_kernel1d (truncate=4)."""
    if radius is None:
        radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return (phi / phi.sum()).astype(np.float32)


def gaussian_kernel1d_cv(ksize: int, sigma: float) -> np.ndarray:
    """Gaussian taps identical to cv2.getGaussianKernel(ksize, sigma)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    phi = np.exp(-(x ** 2) / (2.0 * sigma * sigma))
    return (phi / phi.sum()).astype(np.float32)


def _border_index(n: int, pad: int, mode: BoundaryMode) -> np.ndarray:
    """Source index of each of the ``n + 2·pad`` padded positions."""
    if pad > n - (mode == 'reflect'):
        raise ValueError(f"pad {pad} too wide for an axis of {n} ({mode})")
    i = np.arange(-pad, n + pad)
    if mode == 'reflect':          # reflect-101: edge pixel not repeated
        i = np.where(i < 0, -i, i)
        i = np.where(i >= n, 2 * (n - 1) - i, i)
    elif mode == 'symmetric':      # scipy 'reflect': edge pixel repeated
        i = np.where(i < 0, -i - 1, i)
        i = np.where(i >= n, 2 * n - 1 - i, i)
    else:
        raise ValueError(f"unknown border mode {mode!r}")
    return i


def pad_axis(x: torch.Tensor, axis: int, pad: int,
             mode: BoundaryMode) -> torch.Tensor:
    """Pad ``x`` by ``pad`` on both sides of ``axis`` with border ``mode``."""
    idx = const(_border_index, x.shape[axis], pad, mode, device=x.device,
                dtype=torch.long)
    return x.index_select(axis, idx)


def _conv_axis(x: torch.Tensor, taps: np.ndarray, axis: int,
               mode: BoundaryMode) -> torch.Tensor:
    """1-D correlation of NHWC ``x`` along H (axis=1) or W (axis=2)."""
    k = len(taps)
    xp = pad_axis(x, axis, k // 2, mode)
    n = x.shape[axis]
    out = None
    for i in range(k):
        term = xp.narrow(axis, i, n) * float(taps[i])
        out = term if out is None else out + term
    return out


def separable_filter(x: torch.Tensor, taps_h: np.ndarray, taps_w: np.ndarray,
                     mode: BoundaryMode = 'reflect') -> torch.Tensor:
    """Apply a separable filter (rows then cols) to NHWC ``x``."""
    return _conv_axis(_conv_axis(x, taps_h, 1, mode), taps_w, 2, mode)


def gaussian_blur_cv(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) on NHWC batches."""
    taps = gaussian_kernel1d_cv(ksize, sigma)
    return separable_filter(x, taps, taps, mode='reflect')


def gaussian_filter_scipy(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter(img, sigma) on NHWC batches."""
    taps = gaussian_kernel1d_scipy(sigma)
    return separable_filter(x, taps, taps, mode='symmetric')


def laplacian(x: torch.Tensor) -> torch.Tensor:
    """cv2.Laplacian(gray, ksize=1) on NHWC batches (reflect-101 border)."""
    xp = pad_axis(pad_axis(x, 1, 1, 'reflect'), 2, 1, 'reflect')
    h, w = x.shape[1], x.shape[2]
    return (xp[:, 0:h, 1:w + 1] + xp[:, 2:h + 2, 1:w + 1]
            + xp[:, 1:h + 1, 0:w] + xp[:, 1:h + 1, 2:w + 2]
            - 4.0 * xp[:, 1:h + 1, 1:w + 1])


def rgb_to_gray_cv_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """Bit-exact cv2.cvtColor(RGB2GRAY) on uint8: fixed-point
    (R·4899 + G·9617 + B·1868 + 2^13) >> 14. NHWC uint8 → NHW1 uint8."""
    xi = x_u8.to(torch.int32)
    g = (xi[..., 0] * 4899 + xi[..., 1] * 9617 + xi[..., 2] * 1868
         + (1 << 13)) >> 14
    return g.to(torch.uint8)[..., None]


