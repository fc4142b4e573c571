"""Spatial-reduction attention core (counterpart of ``awsegbench/ops/attention.py``).

``sr_attention(q, k, v, scale) = softmax(q·kᵀ·scale)·v`` on ``[G, N, D]``
queries and ``[G, M, D]`` reduced keys/values, the op
``awseg::sr_attention``. On CUDA tensors it launches
``csrc/sr_attention.cu`` (online softmax, K/V streamed through shared
memory, D ∈ {32, 64}) and its gradient ``csrc/sr_attention_bwd.cu`` (P
recomputed, dq per query tile, dk/dv per key tile over splits of the
queries, summed in order). Each file holds two designs, chosen by
:func:`_design` from the dtype: bf16 runs on the tensor cores
(``mma.sync``), f32 on the CUDA cores (TF32 would break f32 parity). On
CPU tensors it runs :func:`sr_attention_plain`, the einsum/softmax of the
JAX package's ``sr_attention_reference``, and plain autograd through it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

# Query rows per split of the dk/dv kernel: N/1024 splits give the card
# enough blocks at MiT stage 1 (G = 8, M = 512). Of 512 to 8192, swept on an
# H100 by scripts/tune_sr_attention_split.py, 1024 took the least device
# time per step; the others were within 12% of it.
_SPLIT_ROWS = 1024
DESIGNS = ('mma_bf16', 'simt_f32')


def sr_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """f32 scores, f32 softmax, probabilities in v's dtype for the AV
    product, output in q's dtype (``sr_attention_reference``)."""
    s = torch.einsum('gnd,gmd->gnm', q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum('gnm,gmd->gnd', p, v).to(q.dtype)


def _design(dtype: torch.dtype, d: int) -> str:
    """The kernel design that takes q/k/v of ``dtype`` and head_dim ``d``:
    ``'mma_bf16'`` (tensor cores) for bf16, ``'simt_f32'`` (CUDA cores) for
    f32. Raises for any other dtype or head_dim."""
    if d not in (32, 64):
        raise ValueError(f'the CUDA kernels take head_dim 32 or 64, got {d}')
    if dtype == torch.bfloat16:
        return 'mma_bf16'
    if dtype == torch.float32:
        return 'simt_f32'
    raise TypeError(f'the CUDA kernels take f32 or bf16, got {dtype}')


def _check(q, k, v, what) -> str:
    """Validates q/k/v for a launch; returns their design."""
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f'{what}: q/k/v must share a dtype, got '
                        f'{q.dtype}, {k.dtype}, {v.dtype}')
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f'{what}: bad shapes q {tuple(q.shape)}, '
                         f'k {tuple(k.shape)}, v {tuple(v.shape)}')
    if not (k.device == v.device == q.device):
        raise ValueError(f'{what}: q, k, v on different devices')
    return _design(q.dtype, q.shape[2])


def _launch(q, k, v, scale):
    design = _check(q, k, v, 'sr_attention')
    g, n, d = q.shape
    m = k.shape[1]
    q, k, v = _build.operand(q), _build.operand(k), _build.operand(v)
    out = torch.empty_like(q)
    if g * n == 0 or m == 0:
        return out
    _build.launch('sr_attention', 'sr_attention', 'sr_attention_launch',
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                  + [ctypes.c_float], q, k, v, out, g, n, m, d,
                  int(q.dtype == torch.bfloat16), float(scale),
                  design=design)
    return out


def sr_attention_backward_plain(q, k, v, dout, scale):
    """Plain version of the backward kernel: autograd through
    :func:`sr_attention_plain`. Returns (dq, dk, dv) in q/k/v's dtypes."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = sr_attention_plain(*qkv, scale)
        return torch.autograd.grad(out, qkv, dout)


def _launch_backward(q, k, v, dout, scale):
    design = _check(q, k, v, 'sr_attention_backward')
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device:
        raise ValueError(f'sr_attention_backward: dout {tuple(dout.shape)} '
                         f'{dout.dtype} does not match q')
    g, n, d = q.shape
    m = k.shape[1]
    q, k, v, dout = (_build.operand(t) for t in (q, k, v, dout))
    f32 = dict(dtype=torch.float32, device=q.device)
    if g * n == 0 or m == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    dq = torch.empty_like(q)
    dk = torch.empty((g, m, d), **f32)       # the reduce kernel writes all
    dv = torch.empty((g, m, d), **f32)
    splits = -(-n // _SPLIT_ROWS)
    stats = torch.empty((3, g, n), **f32)
    pk = torch.empty((splits, g, m, d), **f32)
    pv = torch.empty((splits, g, m, d), **f32)
    _build.launch('sr_attention_backward', 'sr_attention_bwd',
                  'sr_attention_bwd_launch', [ctypes.c_void_p] * 10
                  + [ctypes.c_int] * 6 + [ctypes.c_float], q, k, v, dout,
                  dq, stats, pk, pv, dk, dv, g, n, m, d,
                  int(q.dtype == torch.bfloat16), _SPLIT_ROWS, float(scale),
                  design=design)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def sr_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          dout: torch.Tensor, scale: float):
    """(dq, dk, dv) of :func:`sr_attention` for the output gradient
    ``dout`` [G, N, D]; dq in q's dtype, dk/dv summed in f32 and returned
    in k/v's dtype: the op ``awseg::sr_attention_backward``, K6 on CUDA
    tensors, the plain version on CPU tensors."""
    return torch.ops.awseg.sr_attention_backward(q, k, v, dout, scale)


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """``softmax(q·kᵀ·scale)·v``: q [G, N, D], k/v [G, M, D] → [G, N, D]
    in q's dtype: the op ``awseg::sr_attention``, K1 on CUDA tensors (K6
    under autograd), the plain version on CPU tensors."""
    return torch.ops.awseg.sr_attention(q, k, v, scale)
