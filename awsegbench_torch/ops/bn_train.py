"""Train-mode BatchNorm with its residual add and ReLU as one op with a
registered gradient (K13 forward, K14 backward; no counterpart in the JAX
package, where XLA fused BN into the convs).

``bn_train(x, weight, bias, eps, residual, relu)``: x [N, C, ...] (BN over
channel dim 1) → ``(y, stats)`` with ``y = act((x − mean)·(rsqrt(var +
eps)·weight) + bias [+ residual])`` from the batch's f32 statistics (the
fast variance ``E[x²] − E[x]²``, clamped at 0; Flax ``nn.BatchNorm``'s
train mode) and ``stats`` [4, C] f32: mean, the biased var, r = rsqrt(var +
eps) and 1 where the variance was not clamped (else 0). It is the custom
op ``awseg::bn_train`` (``ops/library.py``); its gradient is the op
``awseg::bn_train_backward``, which saves x, y (with ReLU) and ``stats``
and no f32 activation. Under a data-parallel mesh
(``parallel.collectives``) the per-channel sums are the global batch's:
the forward's (Σx, Σx²) and the backward's (Σg'x̂, Σg') are summed over
the ranks between the two passes of each, and n counts every rank's rows.

On CUDA tensors the ops launch ``csrc/bn_train.cu`` (one launch a call, or
two under a mesh: the sums, then the pass that reads them): bf16 or f32
operands, f32 statistics and arithmetic, y rounded once to x's dtype, in
x's layout. On CPU tensors they run :func:`bn_train_plain`, the
composition the models ran before the kernels, op for op, and
:func:`bn_train_backward_plain`, the gradient's formula. A CUDA tensor
never takes the plain version.

The kernels take x, the residual and the gradients dense in one of the
two layouts ``ops.bn_act`` takes: channels-last or contiguous; weight and
bias are C values in x's dtype. Anything else raises; an upstream
gradient in another layout is copied into x's.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from ..parallel.collectives import (active_mesh, all_reduce_, global_rows,
                                    sync_sum)
from .bn_act import layout

# the rows of ``stats``
MEAN, VAR, RSTD, KEEP = range(4)


def _dims_shape(x: torch.Tensor):
    return (0,) + tuple(range(2, x.ndim)), (1, -1) + (1,) * (x.ndim - 2)


def _count(x: torch.Tensor) -> int:
    """A channel's elements over the mesh's ranks."""
    return global_rows(x.shape[0]) * (x.numel() // x.shape[0] // x.shape[1])


def bn_train_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, residual: Optional[torch.Tensor] = None,
                   relu: bool = False):
    """BN's train form as the models ran it before the op: the statistics
    in the promoted f32 dtype, ``(xf − mean)·(rsqrt(var + eps)·weight) +
    bias`` rounded to the dtype of x and weight, then ``+ residual``, then
    the ReLU, each op rounding; returns ``(y, stats)``."""
    dims, shape = _dims_shape(x)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if active_mesh() is None:
        mean = xf.mean(dims)
        sq = (xf * xf).mean(dims)
    else:   # the global batch's statistics, over every rank's rows
        n = _count(xf)
        mean = sync_sum(xf.sum(dims)) / n
        sq = sync_sum((xf * xf).sum(dims)) / n
    d = sq - mean * mean
    var = torch.clamp(d, min=0.0)
    rstd = torch.rsqrt(var + eps)
    mul = rstd * weight
    y = (xf - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    y = y.to(torch.result_type(x, weight))
    if residual is not None:
        y = y + residual
    y = F.relu(y) if relu else y
    return y, torch.stack([mean, var, rstd, (d >= 0).to(mean.dtype)])


def bn_train_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                            y: Optional[torch.Tensor], stats: torch.Tensor,
                            weight: torch.Tensor, want_dres: bool):
    """The gradient of :func:`bn_train_plain` for the upstream ``dy``, by
    its formula: with x̂ = (x − mean)·r and g' = dy masked where y ≤ 0 (y
    given: ReLU), ``dx = weight·r·(g' − Σg'/n − x̂·Σg'x̂/n)`` (the last term
    0 where the variance was clamped) in x's dtype; ``dres`` = g' where
    ``want_dres``, else an empty tensor; ``dwb`` [2, C] = (Σg'x̂, Σg') in
    weight's dtype, this rank's sums. Under a mesh the sums in dx are the
    ranks' total."""
    dims, shape = _dims_shape(x)
    g = dy if y is None else torch.where(y <= 0, 0, dy)
    gf = g.to(stats.dtype)
    mean, _, rstd, keep = stats
    xhat = (x.to(stats.dtype) - mean.view(shape)) * rstd.view(shape)
    sums = torch.stack([(gf * xhat).sum(dims), gf.sum(dims)])
    dwb = sums.to(weight.dtype)
    mesh = active_mesh()
    if mesh is not None:
        sums = all_reduce_(sums.clone(), mesh)
    sgx, sg = sums / _count(x)
    dx = ((weight.to(stats.dtype) * rstd).view(shape)
          * (gf - sg.view(shape) - xhat * (keep * sgx).view(shape)))
    dres = (g.clone() if g is dy else g) if want_dres else dy.new_empty(0)
    return dx.to(x.dtype), dres, dwb


def check(x, weight, bias, residual, what: str = 'bn_train') -> str:
    """Validates the forward's operands for the kernel; returns x's
    layout."""
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError(f'{what}: x is a non-empty [N, C, ...], got '
                         f'{tuple(x.shape)}')
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'{what}: the CUDA kernel takes bf16 or f32, got '
                        f'{x.dtype}')
    c = x.shape[1]
    for name, t in (('weight', weight), ('bias', bias)):
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


def _geometry(x: torch.Tensor, lay: str):
    """(outer, C, inner) of x's memory, and the ``float`` workspace for the
    kernels' partial sums after the [2, C] sums."""
    c = x.shape[1]
    inner = 1 if lay == 'nhwc' else x.numel() // (x.shape[0] * c)
    outer = x.numel() // (c * inner)
    fn = _build.load('bn_train').bn_train_workspace
    if fn.restype is not ctypes.c_int64:
        fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int64]
        fn.restype = ctypes.c_int64
    sums = torch.empty(2 * c + fn(outer, c, inner), dtype=torch.float32,
                       device=x.device)
    return outer, c, inner, sums


def _in_layout(t: torch.Tensor, lay: str) -> torch.Tensor:
    if layout(t) == lay:
        return t
    return t.contiguous(memory_format=torch.channels_last if lay == 'nhwc'
                        else torch.contiguous_format)


_FWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_float, ctypes.c_float,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_float, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_int]


def _phases(op, symbol, argtypes, sums, c, head, tail):
    """One launch of all phases, or under a mesh phase 1, the sums reduced
    over the ranks, then phase 2."""
    mesh = active_mesh()
    if mesh is None:
        _build.launch(op, 'bn_train', symbol, argtypes, *head, *tail, 3)
        return
    _build.launch(op, 'bn_train', symbol, argtypes, *head, *tail, 1)
    all_reduce_(sums[:2 * c], mesh)
    _build.launch(op, 'bn_train', symbol, argtypes, *head, *tail, 2)


def _launch_forward(x, weight, bias, eps, residual=None, relu=False):
    lay = check(x, weight, bias, residual)
    outer, c, inner, sums = _geometry(x, lay)
    y = torch.empty_like(x)
    stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
    _phases('bn_train', 'bn_train_forward', _FWD_ARGS, sums, c,
            (x, residual, y, weight, bias, sums, stats, sums[2 * c:], eps,
             float(_count(x))),
            (outer, c, inner, int(relu), int(x.dtype == torch.bfloat16)))
    return y, stats


def _launch_backward(dy, x, y, stats, weight, want_dres):
    lay = check(x, weight, weight, None, 'bn_train_backward')
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f'bn_train_backward: dy {tuple(dy.shape)} '
                         f'{dy.dtype} does not match x {tuple(x.shape)} '
                         f'{x.dtype}')
    if y is not None and (y.shape != x.shape or y.dtype != x.dtype
                          or layout(y) != lay):
        raise ValueError('bn_train_backward: y does not match x')
    if stats.shape != (4, x.shape[1]) or stats.dtype != torch.float32:
        raise ValueError(f'bn_train_backward: stats must be [4, C] f32, got '
                         f'{tuple(stats.shape)} {stats.dtype}')
    dy = _in_layout(dy, lay)
    outer, c, inner, sums = _geometry(x, lay)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if want_dres else x.new_empty(0)
    dwb = torch.empty((2, c), dtype=x.dtype, device=x.device)
    _phases('bn_train_backward', 'bn_train_backward', _BWD_ARGS, sums, c,
            (dy, x, y, stats.contiguous(), weight, dx,
             dres if want_dres else None, sums, dwb, sums[2 * c:],
             float(_count(x))),
            (outer, c, inner, int(x.dtype == torch.bfloat16)))
    return dx, dres, dwb


def bn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float, residual: Optional[torch.Tensor] = None,
             relu: bool = False):
    """Train-mode BN and its epilogue (module docstring): the op
    ``awseg::bn_train``, K13 on CUDA tensors (K14 under autograd), the
    plain versions on CPU tensors; returns ``(y, stats)``."""
    return torch.ops.awseg.bn_train(x, weight, bias, float(eps), residual,
                                    bool(relu))
