"""Eval-mode BatchNorm with its residual add and ReLU in one pass (K12; no
counterpart in the JAX package, where XLA fused BN into the convs).

``bn_act(x, mean, var, weight, bias, eps, residual, relu)``: x [N, C, ...]
(BN over channel dim 1) → ``act((x − mean)·(rsqrt(var + eps)·weight) +
bias [+ residual])``, act ReLU where ``relu`` is set, else the identity.
It is the custom op ``awseg::bn_act`` (``ops/library.py``). On CUDA
tensors it launches ``csrc/bn_act.cu``, eval only: f32 arithmetic from
bf16 or f32 operands, rounded once to x's dtype, into a new tensor in x's
layout. On CPU tensors it runs :func:`bn_act_plain`, the composition the
models ran before the kernel, op for op. A CUDA tensor never takes the
plain version.

The kernel takes x, and the residual, dense in one of two layouts, both
in the same: channels-last (the NHWC models' convs give it) or
contiguous. Anything else raises; nothing is copied into a layout it
takes. The per-channel tensors are C values in x's dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build


def bn_act_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, eps: float,
                 residual: Optional[torch.Tensor] = None,
                 relu: bool = False) -> torch.Tensor:
    """BN's eval form as Flax computes it, ``(x − mean)·(rsqrt(var + eps)·
    weight) + bias`` in the promoted dtype, then ``+ residual``, then the
    ReLU: each op rounds to that dtype (the kernel rounds once)."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mul = torch.rsqrt(var + eps) * weight
    y = (x - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def layout(x: torch.Tensor) -> Optional[str]:
    """'nchw' for a contiguous tensor, 'nhwc' for a channels-last 4-D one
    (a tensor that is both, with H·W = 1 or C = 1, reads as 'nchw'), else
    None."""
    if x.is_contiguous():
        return 'nchw'
    if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return 'nhwc'
    return None


def check(x, mean, var, weight, bias, residual, what: str = 'bn_act') -> str:
    """Validates the operands for the kernel; returns x's layout."""
    if x.ndim < 2:
        raise ValueError(f'{what}: x is [N, C, ...], got {tuple(x.shape)}')
    c = x.shape[1]
    for name, t in (('mean', mean), ('var', var), ('weight', weight),
                    ('bias', bias)):
        if t.ndim != 1 or t.shape[0] != c or not t.is_contiguous():
            raise ValueError(f'{what}: {name} must hold {c} contiguous '
                             f'values, got {tuple(t.shape)}')
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f'{what}: {name} is {t.dtype} on {t.device}, x '
                            f'{x.dtype} on {x.device}')
    lay = layout(x)
    if lay is None:
        raise ValueError(f'{what}: x must be contiguous or channels-last, '
                         f'got strides {x.stride()} for {tuple(x.shape)}')
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device):
            raise ValueError(f'{what}: the residual {tuple(residual.shape)} '
                             f'{residual.dtype} does not match x '
                             f'{tuple(x.shape)} {x.dtype}')
        if layout(residual) != lay:
            raise ValueError(f'{what}: the residual (strides '
                             f'{residual.stride()}) is not in x\'s layout, '
                             f'{lay}')
    return lay


def _launch(x, mean, var, weight, bias, eps, residual=None, relu=False):
    lay = check(x, mean, var, weight, bias, residual)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'bn_act: the CUDA kernel takes bf16 or f32, got '
                        f'{x.dtype}')
    y = torch.empty_like(x)
    n, c = x.numel(), x.shape[1]
    if n == 0:
        return y
    inner = 1 if lay == 'nhwc' else n // (x.shape[0] * c)
    _build.launch('bn_act', 'bn_act', 'bn_act_launch',
                  [ctypes.c_void_p] * 7 + [ctypes.c_float, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int],
                  x, residual, y, mean, var, weight, bias, eps, n, c, inner,
                  int(relu), int(x.dtype == torch.bfloat16))
    return y


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
           weight: torch.Tensor, bias: torch.Tensor, eps: float,
           residual: Optional[torch.Tensor] = None,
           relu: bool = False) -> torch.Tensor:
    """The eval BN and its epilogue (module docstring): the op
    ``awseg::bn_act``, K12 on CUDA tensors, the plain version on CPU
    tensors."""
    return torch.ops.awseg.bn_act(x, mean, var, weight, bias, float(eps),
                                  residual, bool(relu))
