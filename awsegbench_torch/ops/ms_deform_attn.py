"""Multi-scale deformable attention sampling (K11; no counterpart in the
JAX package).

``ms_deform_attn(value, shapes, loc, attn)``: value [B, S, M, D] (the
levels' maps flattened and concatenated, level l of ``shapes[2l]`` ×
``shapes[2l + 1]`` pixels), loc [B, Lq, M, L, P, 2] f32 sampling locations
(x, y) in [0, 1], attn [B, Lq, M, L, P] f32 weights → [B, Lq, M·D] in
value's dtype: each head's bilinear samples (``align_corners=False``, zeros
outside the map) weighted and summed over the levels and points, in f32.
It is the custom op ``awseg::ms_deform_attn`` (``ops/library.py``). On
CUDA tensors it launches ``csrc/ms_deform_attn.cu``, eval only; on CPU
tensors it runs :func:`ms_deform_attn_plain`, ``F.grid_sample`` per level
as Deformable DETR's ``ms_deform_attn_core_pytorch`` writes it. A CUDA
tensor never takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build


def level_sizes(shapes) -> list[tuple[int, int]]:
    """``shapes`` (H0, W0, H1, W1, ...) as (H, W) pairs."""
    return [(int(shapes[i]), int(shapes[i + 1]))
            for i in range(0, len(shapes), 2)]


def ms_deform_attn_plain(value: torch.Tensor, shapes: list[int],
                         loc: torch.Tensor, attn: torch.Tensor
                         ) -> torch.Tensor:
    """The sampling in f32 through ``F.grid_sample``, rounded once to
    value's dtype (the kernel's numerics)."""
    b, _, m, d = value.shape
    lq, n_levels, n_points = loc.shape[1], loc.shape[3], loc.shape[4]
    sizes = level_sizes(shapes)
    levels = value.float().split([h * w for h, w in sizes], dim=1)
    grids = 2.0 * loc.float() - 1.0
    sampled = []
    for lvl, (h, w) in enumerate(sizes):
        v = levels[lvl].permute(0, 2, 3, 1).reshape(b * m, d, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(b * m, lq,
                                                        n_points, 2)
        sampled.append(F.grid_sample(v, g, mode='bilinear',
                                     padding_mode='zeros',
                                     align_corners=False))
    weights = attn.float().transpose(1, 2).reshape(b * m, 1, lq,
                                                   n_levels * n_points)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * weights).sum(-1)
    return (out.view(b, m * d, lq).transpose(1, 2).contiguous()
            .to(value.dtype))


def check(value, shapes, loc, attn, what: str = 'ms_deform_attn') -> None:
    """Validates the operands' shapes and dtypes."""
    if value.ndim != 4 or loc.ndim != 6 or attn.ndim != 5:
        raise ValueError(f'{what}: value [B, S, M, D], loc [B, Lq, M, L, P, '
                         f'2] and attn [B, Lq, M, L, P], got {tuple(value.shape)}'
                         f', {tuple(loc.shape)}, {tuple(attn.shape)}')
    b, s, m, d = value.shape
    sizes = level_sizes(shapes)
    if (loc.shape[0] != b or loc.shape[2] != m or loc.shape[5] != 2
            or loc.shape[3] != len(sizes) or attn.shape != loc.shape[:5]):
        raise ValueError(f'{what}: loc {tuple(loc.shape)} and attn '
                         f'{tuple(attn.shape)} do not match value '
                         f'{tuple(value.shape)} and {len(sizes)} levels')
    if sum(h * w for h, w in sizes) != s:
        raise ValueError(f'{what}: the levels {sizes} do not hold {s} '
                         'pixels')
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError(f'{what}: loc and attn are f32, got {loc.dtype}, '
                        f'{attn.dtype}')


def _launch(value, shapes, loc, attn):
    check(value, shapes, loc, attn)
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError('ms_deform_attn: the CUDA kernel takes bf16 or f32 '
                        f'values, got {value.dtype}')
    b, s, m, d = value.shape
    lq, n_levels, n_points = loc.shape[1], loc.shape[3], loc.shape[4]
    if d % 8 or n_levels > 4:
        raise ValueError(f'ms_deform_attn: the CUDA kernel takes D % 8 == 0 '
                         f'and at most 4 levels, got D {d}, {n_levels}')
    value, loc, attn = (_build.operand(t) for t in (value, loc, attn))
    out = value.new_empty((b, lq, m * d))
    hw = (ctypes.c_int * (2 * n_levels))(*(int(x) for x in shapes))
    _build.launch('ms_deform_attn', 'ms_deform_attn', 'ms_deform_attn_launch',
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                  + [ctypes.c_void_p, ctypes.c_int], value, loc, attn, out,
                  b, s, lq, m, d, n_levels, n_points, hw,
                  int(value.dtype == torch.bfloat16))
    return out


def ms_deform_attn(value: torch.Tensor, shapes, loc: torch.Tensor,
                   attn: torch.Tensor) -> torch.Tensor:
    """The sampling (module docstring): the op ``awseg::ms_deform_attn``,
    K11 on CUDA tensors, the plain version on CPU tensors."""
    return torch.ops.awseg.ms_deform_attn(value, [int(x) for x in shapes],
                                          loc, attn)
