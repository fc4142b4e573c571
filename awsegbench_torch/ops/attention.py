"""Spatial-reduction attention core (counterpart of ``awsegbench/ops/attention.py``).

``sr_attention(q, k, v, scale) = softmax(q·kᵀ·scale)·v`` on ``[G, N, D]``
queries and ``[G, M, D]`` reduced keys/values. On a CUDA tensor it launches
the hand-written kernel ``csrc/sr_attention.cu`` (online softmax, K/V
streamed through shared memory, D ∈ {32, 64}); on a CPU tensor it runs
:func:`sr_attention_plain`, the einsum/softmax of the JAX package's
``sr_attention_reference``. Forward only: the backward kernel comes with
the train slice.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build


def sr_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """f32 scores, f32 softmax, probabilities in v's dtype for the AV
    product, output in q's dtype (``sr_attention_reference``)."""
    s = torch.einsum('gnd,gmd->gnm', q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum('gnm,gmd->gnd', p, v).to(q.dtype)


def _launch(q, k, v, scale):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f'sr_attention: q/k/v must share f32 or bf16, got '
                        f'{q.dtype}, {k.dtype}, {v.dtype}')
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f'sr_attention: bad shapes q {tuple(q.shape)}, '
                         f'k {tuple(k.shape)}, v {tuple(v.shape)}')
    if not (k.device == v.device == q.device):
        raise ValueError('sr_attention: q, k, v on different devices')
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError('sr_attention: the CUDA kernel is forward '
                                  'only; its backward comes with the train '
                                  'step')
    g, n, d = q.shape
    m = k.shape[1]
    if d not in (32, 64):
        raise ValueError(f'sr_attention: the CUDA kernel takes head_dim 32 '
                         f'or 64, got {d}')
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if g * n == 0 or m == 0:
        return out
    lib = _build.load('sr_attention')
    lib.sr_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    lib.sr_attention_launch.restype = ctypes.c_int
    rc = lib.sr_attention_launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        g, n, m, d, int(q.dtype == torch.bfloat16), float(scale),
        _build.stream_ptr(q))
    _build.check(lib, rc, 'sr_attention')
    sr_attention.launches += 1
    return out


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """``softmax(q·kᵀ·scale)·v``: q [G, N, D], k/v [G, M, D] → [G, N, D]
    in q's dtype. CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    if q.is_cuda:
        return _launch(q, k, v, scale)
    return sr_attention_plain(q, k, v, scale)


sr_attention.launches = 0
