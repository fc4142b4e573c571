"""Shifted-window attention with a relative position bias (K15; no
counterpart in the JAX package, which has no Swin).

``window_attention(qkv, table, heads, window, shift, scale)``: qkv [B, Hp,
Wp, 3·heads·D] (the qkv projection of a map already padded to multiples of
``window``, in map order; q, k, v each [heads, D] a token), table
[(2·window − 1)², heads] (the relative position bias table) → [B, Hp, Wp,
heads·D] in map order: Swin's window attention (arXiv:2103.14030) with the
roll, the window partition, its reverse and the roll back folded in. For
every batch row, window of the map rolled by (−shift, −shift), and head,

    out = softmax(q·kᵀ·scale + table[rel(i, j), h] + mask(i, j))·v

over the window's window² tokens, where ``rel`` is the published
``relative_position_index`` and ``mask`` is −100 between tokens of
different regions of the rolled map (three slices an axis, as the
published ``img_mask``; none when ``shift`` is 0). It is the custom op
``awseg::window_attention`` (``ops/library.py``). On CUDA tensors it
launches ``csrc/window_attention.cu``, eval only (bf16 on the tensor cores,
f32 on the CUDA cores; D = 32, window ≤ 12), which gives the −100 of the
mask an exact zero weight; on CPU tensors it runs
:func:`window_attention_plain`, the published composition in f32. A CUDA
tensor never takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._device import const

DESIGNS = ('mma_bf16', 'simt_f32')
MAX_WINDOW, HEAD_DIM = 12, 32


def relative_position_index(window: int) -> torch.Tensor:
    """The published ``relative_position_index`` [window², window²]: for
    tokens i, j of a window at (yi, xi), (yj, xj), (yi − yj + window − 1)·
    (2·window − 1) + xi − xj + window − 1."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing='ij')
    coords = torch.stack((ys.flatten(), xs.flatten()))          # [2, N]
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def shift_mask(hp: int, wp: int, window: int, shift: int) -> torch.Tensor:
    """The published attention mask of the rolled map's windows, [nW, N,
    N]: 0 within a region, −100 across two (regions: the slices (0, −w),
    (−w, −s), (−s, end) of each axis)."""
    img = torch.zeros(hp, wp)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for h in cuts:
        for w in cuts:
            img[h, w] = cnt
            cnt += 1
    win = partition(img[None, :, :, None], window).reshape(-1,
                                                           window * window)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] → [B·nW, window, window, C], windows row by row."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)


def unpartition(x: torch.Tensor, window: int, h: int, w: int
                ) -> torch.Tensor:
    """The inverse of :func:`partition`: [B·nW, window, window, C] →
    [B, h, w, C]."""
    c = x.shape[-1]
    x = x.view(-1, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def window_attention_published(qkv: torch.Tensor, table: torch.Tensor,
                               heads: int, window: int, shift: int,
                               scale: float) -> torch.Tensor:
    """The published composition in qkv's dtype: roll, partition, scores,
    bias and mask added, softmax, the product, reverse, roll back. The
    scores, the gathered bias and the mask are materialised."""
    b, hp, wp, c3 = qkv.shape
    c, n = c3 // 3, window * window
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = partition(x, window).reshape(-1, n, 3, heads, c // heads)
    q, k, v = x.permute(2, 0, 3, 1, 4).unbind(0)        # [B·nW, heads, N, D]
    attn = (q * scale) @ k.transpose(-2, -1)
    index = const(relative_position_index, window, device=qkv.device,
                  dtype=torch.long)
    bias = table[index.view(-1)].view(n, n, heads).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if shift:
        mask = const(shift_mask, hp, wp, window, shift, device=qkv.device,
                     dtype=attn.dtype)
        nw = mask.shape[0]
        attn = (attn.view(-1, nw, heads, n, n)
                + mask.unsqueeze(1).unsqueeze(0)).view(-1, heads, n, n)
    out = (attn.softmax(-1) @ v).transpose(1, 2).reshape(-1, window, window,
                                                         c)
    out = unpartition(out, window, hp, wp)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                           heads: int, window: int, shift: int,
                           scale: float) -> torch.Tensor:
    """The published composition in f32, rounded once to qkv's dtype."""
    return window_attention_published(qkv.float(), table.float(), heads,
                                      window, shift, scale).to(qkv.dtype)


def check(qkv, table, heads: int, window: int, shift: int,
          what: str = 'window_attention') -> None:
    """Validates the operands' shapes and the window's geometry."""
    if qkv.ndim != 4 or table.ndim != 2:
        raise ValueError(f'{what}: qkv [B, Hp, Wp, 3C] and table [(2w-1)^2, '
                         f'heads], got {tuple(qkv.shape)}, '
                         f'{tuple(table.shape)}')
    b, hp, wp, c3 = qkv.shape
    if heads < 1 or c3 % (3 * heads):
        raise ValueError(f'{what}: {c3} qkv channels are not 3 × {heads} '
                         'heads')
    if window < 1 or hp % window or wp % window:
        raise ValueError(f'{what}: the map {hp}×{wp} is not padded to '
                         f'windows of {window}')
    if not 0 <= shift < window:
        raise ValueError(f'{what}: shift {shift} outside [0, {window})')
    if table.shape != ((2 * window - 1) ** 2, heads):
        raise ValueError(f'{what}: table {tuple(table.shape)} for window '
                         f'{window} and {heads} heads')


def _launch(qkv, table, heads, window, shift, scale):
    check(qkv, table, heads, window, shift)
    if qkv.dtype == torch.bfloat16:
        design = 'mma_bf16'
    elif qkv.dtype == torch.float32:
        design = 'simt_f32'
    else:
        raise TypeError(f'window_attention: the CUDA kernel takes bf16 or '
                        f'f32, got {qkv.dtype}')
    b, hp, wp, c3 = qkv.shape
    d = c3 // (3 * heads)
    if d != HEAD_DIM or window > MAX_WINDOW or table.dtype != qkv.dtype:
        raise ValueError(f'window_attention: the CUDA kernel takes head dim '
                         f'{HEAD_DIM}, windows up to {MAX_WINDOW} and the '
                         f'table in qkv\'s dtype, got D {d}, window {window}, '
                         f'{table.dtype}')
    qkv, table = _build.operand(qkv), table.contiguous()
    out = qkv.new_empty((b, hp, wp, c3 // 3))
    if out.numel() == 0:
        return out
    _build.launch('window_attention', 'window_attention',
                  'window_attention_launch',
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                  + [ctypes.c_float], qkv, table, out, b, hp, wp, heads,
                  window, shift, int(qkv.dtype == torch.bfloat16),
                  float(scale), design=design)
    return out


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                     window: int, shift: int, scale: float) -> torch.Tensor:
    """The window attention (module docstring): the op
    ``awseg::window_attention``, K15 on CUDA tensors, the plain version on
    CPU tensors."""
    return torch.ops.awseg.window_attention(qkv, table, heads, window, shift,
                                            scale)
