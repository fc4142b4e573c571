"""Rain/snow splat masks (counterpart of ``awsegbench/ops/splat.py``).

The union coverage mask of up to N capsules: pixel P is covered by segment
AB with radius r iff ``dist(P, AB)² ≤ r²``. One kernel of ``csrc/splat.cu``
computes it, ``splat_tiles_kernel``, one block per (tile, image): it culls
the image's drops to those whose inflated box (:func:`drop_boxes`) meets
the tile and writes each pixel of the tile once, so the mask is allocated
with ``torch.empty`` and never zero-filled. It serves
:func:`splat_coverage_batched` (K3, a batch [B, N, 8] → [B, H, W], tiles of
``BATCH_TILE``), :func:`splat_coverage_windowed` (K4, one image [N, 8] →
[H, W] of at most 1 Mpx, ``IMAGE_TILE``) and :func:`splat_coverage_tiled`
(K5, one image above 1 Mpx, ``LARGE_IMAGE_TILE``).

:func:`splat_coverage` dispatches one image as the JAX package's
``splat_coverage_pallas`` does: up to 1 Mpx after its padding to its 40×256
windows K4, above that K5.

Each of the three is a custom op (``awseg::splat_coverage_batched``,
``_windowed``, ``_tiled``; ``ops/library.py``): a CUDA tensor launches the
kernel, a CPU tensor runs :func:`splat_coverage_plain`, the chunked
distance test of the JAX package's ``_segment_coverage``.
:func:`splat_coverage_tiles_plain` is the plain model of the kernel's tile walk
(cull, then each tile's pixels against its kept drops), which the tests
hold equal to it. The kernels use the same operation order and are built
without multiply-add contraction, so every mask equals its plain version
bit for bit.

The TPU kernel needed its valid drops compacted and y-sorted first
(``prepare_splat_batch``); the CUDA kernels do not, so that step is not
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


# The kernel's tiles, rows × columns (csrc/splat.cu): a batch's (K3), one
# image's up to 1 Mpx (K4) and above it (K5)
BATCH_TILE, IMAGE_TILE, LARGE_IMAGE_TILE = (128, 64), (16, 128), (32, 128)


def _coverage(params: torch.Tensor, px: torch.Tensor,
              py: torch.Tensor) -> torch.Tensor:
    """[N, 8] drops → bool coverage of the pixel grid ``py`` × ``px``
    (``_segment_coverage``'s chunked test, valid drops only)."""
    px, py = px[None, None, :], py[None, :, None]
    cov = torch.zeros((py.shape[1], px.shape[2]), dtype=torch.bool,
                      device=params.device)
    for s in range(0, params.shape[0], _CHUNK):
        p = params[s:s + _CHUNK, :, None, None]          # [c, 8, 1, 1]
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
    return cov


def _grid(start: int, stop: int, device) -> torch.Tensor:
    return torch.arange(start, stop, dtype=torch.float32, device=device)


def splat_coverage_plain(params: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """[B, N, 8] → [B, H, W] float 0/1, ``_segment_coverage`` per image."""
    dev = params.device
    px, py = _grid(0, width, dev), _grid(0, height, dev)
    out = torch.zeros((params.shape[0], height, width), dtype=torch.float32,
                      device=dev)
    for i in range(params.shape[0]):
        out[i] = _coverage(params[i], px, py).to(torch.float32)
    return out


def drop_boxes(params: torch.Tensor) -> torch.Tensor:
    """Each drop's box inflated by r plus one pixel, as the kernels' cull
    computes it (``drop_box`` in ``csrc/splat.cu``): int64 [..., N, 4] of
    (x0, x1, y0, y1), inclusive, unclipped. A pixel the drop covers lies
    inside it."""
    ax, ay, bx, by, r = (params[..., j] for j in range(5))
    return torch.stack([(torch.minimum(ax, bx) - r).floor() - 1,
                        (torch.maximum(ax, bx) + r).ceil() + 1,
                        (torch.minimum(ay, by) - r).floor() - 1,
                        (torch.maximum(ay, by) + r).ceil() + 1],
                       dim=-1).to(torch.int64)


def splat_coverage_tiles_plain(params: torch.Tensor, height: int, width: int,
                               tile: tuple[int, int]) -> torch.Tensor:
    """The kernel's tile walk in plain torch, [B, N, 8] → [B, H, W] float
    0/1: each ``tile`` (rows, columns; ``BATCH_TILE``, ``IMAGE_TILE`` or
    ``LARGE_IMAGE_TILE``), clipped
    to the image, keeps the valid drops whose :func:`drop_boxes` box meets
    it and tests its pixels against those only. It equals
    :func:`splat_coverage_plain` bit for bit when the cull drops no drop
    that covers a pixel of the tile."""
    th, tw = tile
    dev = params.device
    boxes, valid = drop_boxes(params), params[..., 5] > 0
    out = torch.empty((params.shape[0], height, width), dtype=torch.float32,
                      device=dev)
    for i in range(params.shape[0]):
        x0, x1, y0, y1 = boxes[i].unbind(-1)
        for ty in range(0, height, th):
            ty1 = min(ty + th, height)
            for tx in range(0, width, tw):
                tx1 = min(tx + tw, width)
                keep = (valid[i] & (x1 >= tx) & (x0 < tx1)
                        & (y1 >= ty) & (y0 < ty1))
                out[i, ty:ty1, tx:tx1] = _coverage(
                    params[i][keep], _grid(tx, tx1, dev), _grid(ty, ty1, dev))
    return out


def _launch(op, symbol, params, shape, *dims):
    """``symbol`` of ``csrc/splat.cu`` on ``params`` (f32 [B, N, 8] for a
    mask of ``shape`` [B, H, W], [N, 8] for [H, W]) into a new mask, which
    the kernel writes whole; an empty mask launches nothing."""
    if params.dtype != torch.float32 or params.ndim != len(shape) \
            or params.shape[-1] != 8:
        want = '[B, N, 8]' if len(shape) == 3 else '[N, 8]'
        raise ValueError(f'{op}: params must be f32 {want}, got '
                         f'{params.dtype} {tuple(params.shape)}')
    mask = torch.empty(shape, dtype=torch.float32, device=params.device)
    if mask.numel():
        _build.launch(op, 'splat', symbol,
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * len(dims),
                      _build.operand(params), mask, *dims)
    return mask


def _launch_batched(params, height, width):
    return _launch('splat_coverage_batched', 'splat_tiles_launch', params,
                   (len(params), height, width), *params.shape[:2], height,
                   width)


def splat_coverage_batched(params: torch.Tensor, height: int,
                           width: int) -> torch.Tensor:
    """K3: union coverage masks [B, H, W] (float 0/1) of the capsules in
    ``params`` [B, N, 8]. CUDA tensors launch the kernel, CPU tensors take
    the plain version."""
    return torch.ops.awseg.splat_coverage_batched(params, height, width)


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


def splat_coverage_image_plain(params: torch.Tensor, height: int,
                               width: int) -> torch.Tensor:
    """[N, 8] → [H, W]: :func:`splat_coverage_plain` of one image."""
    return splat_coverage_plain(params[None], height, width)[0]


def _launch_windowed(params, height, width):
    return _launch('splat_coverage_windowed', 'splat_tiles_launch', params,
                   (height, width), 1, len(params), height, width)


def _launch_tiled(params, height, width):
    return _launch('splat_coverage_tiled', 'splat_large_launch', params,
                   (height, width), len(params), height, width)


def splat_coverage_windowed(params: torch.Tensor, height: int,
                            width: int) -> torch.Tensor:
    """K4: the mask [H, W] (float 0/1) of one image's capsules [N, 8], K3's
    tile kernel at B = 1. CUDA tensors launch the kernel, CPU tensors take
    the plain version."""
    return torch.ops.awseg.splat_coverage_windowed(params, height, width)


def splat_coverage_tiled(params: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """K5: the mask [H, W] (float 0/1) of one image's capsules [N, 8], K3's
    tile kernel at B = 1 with ``LARGE_IMAGE_TILE``. CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    return torch.ops.awseg.splat_coverage_tiled(params, height, width)


def splat_coverage(params: torch.Tensor, height: int,
                   width: int) -> torch.Tensor:
    """Union coverage mask [H, W] (float 0/1) of one image's capsules
    ``params`` [N, 8]: K4 up to 1 Mpx padded, K5 above (``uses_windowed``)."""
    if uses_windowed(height, width):
        return splat_coverage_windowed(params, height, width)
    return splat_coverage_tiled(params, height, width)
