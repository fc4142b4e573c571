"""Rain/snow splat masks (counterpart of ``awsegbench/ops/splat.py``).

The union coverage mask of up to N capsules: pixel P is covered by segment
AB with radius r iff ``dist(P, AB)² ≤ r²``. Three kernels of
``csrc/splat.cu`` compute it:

* :func:`splat_coverage_batched` (K3), a batch of images [B, N, 8] → [B, H,
  W], one block per drop over the drop's bounding box;
* :func:`splat_coverage` for one image [N, 8] → [H, W], which dispatches as
  the JAX package's ``splat_coverage_pallas`` does: up to 1 Mpx after its
  padding to its 40×256 windows :func:`splat_coverage_windowed` (K4, one
  block per drop), above that :func:`splat_coverage_tiled` (K5, one block
  per 32×32 tile with a bounding-box cull).

On a CPU tensor each runs :func:`splat_coverage_plain`, the chunked
distance test of the JAX package's ``_segment_coverage``. The kernels use
the same operation order and are built without multiply-add contraction,
so every mask equals its plain version bit for bit.

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
    """K3 on params [B, N, 8]."""
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


# ---------------------------------------------------------------------------
# one image: K4 (windowed) and K5 (tiled)
# ---------------------------------------------------------------------------

WIN_H, WIN_W = 40, 256            # the TPU windowed kernel's padding
_WINDOWED_MAX_PIXELS = 1024 * 1024


def uses_windowed(height: int, width: int) -> bool:
    """The JAX dispatch rule: the windowed kernel when the image padded to
    WIN_H×WIN_W multiples holds at most 1 Mpx, else the tiled one."""
    return ((height + (-height) % WIN_H) * (width + (-width) % WIN_W)
            <= _WINDOWED_MAX_PIXELS)


def _launch_one(params, height, width, entry, what):
    if params.dtype != torch.float32 or params.ndim != 2 \
            or params.shape[1] != 8:
        raise ValueError(f'{what}: params must be f32 [N, 8], got '
                         f'{params.dtype} {tuple(params.shape)}')
    params = params.contiguous()
    mask = torch.empty((height, width), dtype=torch.float32,
                       device=params.device)
    lib = _build.load('splat')
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(params), _build.ptr(mask), params.shape[0], height,
            width, _build.stream_ptr(params))
    _build.check(lib, rc, what)
    return mask


def splat_coverage_windowed(params: torch.Tensor, height: int,
                            width: int) -> torch.Tensor:
    """K4: the mask [H, W] (float 0/1) of one image's capsules [N, 8], one
    block per drop. CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    if params.is_cuda:
        mask = _launch_one(params, height, width, 'splat_windowed_launch',
                           'splat_coverage_windowed')
        splat_coverage_windowed.launches += 1
        return mask
    return splat_coverage_plain(params[None], height, width)[0]


splat_coverage_windowed.launches = 0


def splat_coverage_tiled(params: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """K5: the mask [H, W] (float 0/1) of one image's capsules [N, 8], one
    block per 32×32 tile. CUDA tensors launch the kernel, CPU tensors take
    the plain version."""
    if params.is_cuda:
        mask = _launch_one(params, height, width, 'splat_tiled_launch',
                           'splat_coverage_tiled')
        splat_coverage_tiled.launches += 1
        return mask
    return splat_coverage_plain(params[None], height, width)[0]


splat_coverage_tiled.launches = 0


def splat_coverage(params: torch.Tensor, height: int,
                   width: int) -> torch.Tensor:
    """Union coverage mask [H, W] (float 0/1) of one image's capsules
    ``params`` [N, 8]: K4 up to 1 Mpx padded, K5 above (``uses_windowed``)."""
    if uses_windowed(height, width):
        return splat_coverage_windowed(params, height, width)
    return splat_coverage_tiled(params, height, width)
