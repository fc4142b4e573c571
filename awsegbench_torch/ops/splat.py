"""Batched rain/snow splat mask (counterpart of ``awsegbench/ops/splat.py``,
the batched kernel ``splat_coverage_batched``).

``splat_coverage_batched(params, h, w)`` is the union coverage mask of up to
N capsules per image: pixel P is covered by segment AB with radius r iff
``dist(P, AB)² ≤ r²``. On a CUDA tensor it launches ``csrc/splat.cu`` (one
block per drop over the drop's bounding box); on a CPU tensor it runs
:func:`splat_coverage_plain`, the chunked distance test of the JAX
package's ``_segment_coverage``. Both use the same operation order, and the
kernel is built without multiply-add contraction, so the two masks are equal
bit for bit.

The TPU kernel needed its valid drops compacted and y-sorted first
(``prepare_splat_batch``); the CUDA kernel does not, so that step is not
ported.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_CHUNK = 50   # drops per step of the plain version (as _SPLAT_CHUNK)


def pack_params(ax, ay, bx, by, radius, valid) -> torch.Tensor:
    """Stack per-drop [..., N] values into the kernel's [..., N, 8] rows
    (ax, ay, bx, by, radius, valid, 0, 0), float32."""
    zeros = torch.zeros_like(ax, dtype=torch.float32)
    return torch.stack([ax, ay, bx, by, radius, valid.to(torch.float32),
                        zeros, zeros], dim=-1).to(torch.float32)


def splat_coverage_plain(params: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """[B, N, 8] → [B, H, W] float 0/1, ``_segment_coverage`` per image."""
    b, n, _ = params.shape
    dev = params.device
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    py = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    out = torch.zeros((b, height, width), dtype=torch.float32, device=dev)
    for i in range(b):
        cov = torch.zeros((height, width), dtype=torch.bool, device=dev)
        for s in range(0, n, _CHUNK):
            p = params[i, s:s + _CHUNK, :, None, None]      # [c, 8, 1, 1]
            sax, say, sbx, sby, r, v = (p[:, j] for j in range(6))
            dx, dy = sbx - sax, sby - say
            len2 = dx * dx + dy * dy
            t = torch.where(len2 > 0, ((px - sax) * dx + (py - say) * dy)
                            / torch.clamp(len2, min=1e-8), 0.0)
            t = torch.clamp(t, 0.0, 1.0)
            ex = px - (sax + t * dx)
            ey = py - (say + t * dy)
            d2 = ex * ex + ey * ey
            hit = (d2 <= r * r) & (v > 0)
            cov |= hit.any(dim=0)
        out[i] = cov.to(torch.float32)
    return out


def _launch(params, height, width):
    if params.dtype != torch.float32 or params.ndim != 3 \
            or params.shape[2] != 8:
        raise ValueError(f'splat: params must be f32 [B, N, 8], got '
                         f'{params.dtype} {tuple(params.shape)}')
    b, n, _ = params.shape
    params = params.contiguous()
    mask = torch.zeros((b, height, width), dtype=torch.float32,
                       device=params.device)
    if b * n == 0:
        return mask
    lib = _build.load('splat')
    lib.splat_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.splat_launch.restype = ctypes.c_int
    rc = lib.splat_launch(_build.ptr(params), _build.ptr(mask), b, n,
                          height, width, _build.stream_ptr(params))
    _build.check(lib, rc, 'splat_coverage_batched')
    splat_coverage_batched.launches += 1
    return mask


def splat_coverage_batched(params: torch.Tensor, height: int,
                           width: int) -> torch.Tensor:
    """Union coverage masks [B, H, W] (float 0/1) of the capsules in
    ``params`` [B, N, 8]. CUDA tensors launch the kernel, CPU tensors take
    the plain version."""
    if params.is_cuda:
        return _launch(params, height, width)
    return splat_coverage_plain(params, height, width)


splat_coverage_batched.launches = 0
