"""Fused faithful segmentation head, eval mode (counterpart of
``awsegbench/ops/headkernels.py``).

The faithful SegFormer seg head is ``upsample×r → conv3×3 → BN → ReLU →
conv1×1``. Around the kernel, in plain torch as in the JAX package:

* the coarse partial products ``P = f·W1`` (one matmul on the coarse grid),
* the fold of conv bias + eval BN into one affine (``_bn_fold``),
* the exact 1-px border lines (``_paste_seg_borders``), where the conv's
  zero padding differs from the clamped interior formula.

The core, ``seg_core`` (the op ``awseg::seg_core``, ``ops/library.py``),
turns ``P`` into full-resolution logits without storing the full-resolution
256-channel hidden: on a CUDA tensor it launches ``csrc/seg_head.cu`` (K2),
eval only; on a CPU tensor it runs :func:`seg_core_plain`.
K2 has two designs, chosen by :func:`_design` from the dtype: bf16 runs on
the tensor cores (``mma_bf16``: one product against the TPU kernel's
``kron(Ay, Ax)`` phase table, whose entries it rounds to bf16 as the TPU
kernel does), f32 on the CUDA cores (``simt_f32``: the table's two factors
``Ay``/``Ax`` as two 9-tap passes; TF32 would break f32 parity). The plain
version rounds as the kernel for its dtype (:func:`phase_passes`). Class
counts 1 to 32 (``NC_MAX``) reach the kernels; a CUDA tensor with more
raises.

BN here is eval mode, ``y = (x − mean)·scale/sqrt(var + eps) + bias`` with
eps 1e-5, folded as ``a = scale/sqrt(var + eps)``, ``c = bias − mean·a +
conv_bias·a`` in the parameters' dtype.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from .._device import const
from .upconv import _shift_gather, conv1_border_lines

DESIGNS = ('mma_bf16', 'simt_f32')
NC_MAX = 32   # the most classes the seg-head kernels take


def _u(p: float, r: int) -> list[tuple[int, float]]:
    """Bilinear taps (coarse offset, weight) for fine phase p (half-pixel)."""
    s = (p + 0.5) / r - 0.5
    i0 = int(np.floor(s))
    frac = s - i0
    return [(i0, 1.0 - frac), (i0 + 1, frac)]


@functools.lru_cache(maxsize=None)
def _a2(r: int) -> np.ndarray:
    """Ay[p, 3k + d]: weight of coarse offset d−1 for conv tap k at fine
    phase p (tap-major: the y factor)."""
    A = np.zeros((r, 9), np.float32)
    for p in range(r):
        for k in range(3):
            for d, wgt in _u(p + k - 1, r):
                A[p, 3 * k + (d + 1)] += wgt
    return A


@functools.lru_cache(maxsize=None)
def _a2_dmajor(r: int) -> np.ndarray:
    """Ax[q, 3d + k]: the offset-major x factor."""
    A = np.zeros((r, 9), np.float32)
    for p in range(r):
        for k in range(3):
            for d, wgt in _u(p + k - 1, r):
                A[p, 3 * (d + 1) + k] += wgt
    return A


def _ayx(r: int) -> np.ndarray:
    """kron(Ay, Ax) [r², 81]: the TPU kernel's joint-phase table, with rows
    (p·r + q) and columns ((3ky+dy)·9 + 3dx+kx)."""
    return np.kron(_a2(r), _a2_dmajor(r)).astype(np.float32)


def _neighbor_pp(P: torch.Tensor) -> torch.Tensor:
    """Coarse partial products stacked over the clamped 3×3 neighbourhood.

    P [B, h, w, 3(ky), 3(kx), C] → [B, h, w, 81, C], the 81 rows ordered
    ((3ky+dy)·9 + 3dx+kx) like the kron table's columns."""
    P = _shift_gather(P, 1)   # [b,h,3dy,w,ky,kx,C]
    P = _shift_gather(P, 3)   # [b,h,3dy,w,3dx,ky,kx,C]
    b, h, _, w, _, _, _, c = P.shape
    return P.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, h, w, 81, c)


def _bn_fold(bias, scale, offset, mean, var, eps):
    """Fold conv bias + eval-mode BN into one affine (a, c): y = x·a + c."""
    a = scale / torch.sqrt(var + eps)
    c = offset - mean * a + (0.0 if bias is None else bias) * a
    return a, c


def _ayx_bf16(r: int) -> torch.Tensor:
    """kron(Ay, Ax) with each f32 product rounded to bf16 (held in f32): the
    TPU kernel's bf16 phase table, and the bf16 kernels' A operand."""
    return torch.from_numpy(_ayx(r)).bfloat16().float()


def _ayx_bf16_k96(r: int) -> torch.Tensor:
    """[r², 96]: :func:`_ayx_bf16` with its 81 columns padded to the bf16
    kernels' K = 96 with zeros; the bf16 backward body (``csrc/
    seg_bwd_mma.cuh``) reads its kron rows from this table, whose entries
    are the values the forward body forms in registers."""
    return torch.nn.functional.pad(_ayx_bf16(r), (0, 96 - 81))


def phase_passes(pp: torch.Tensor, r: int, kron_bf16: bool) -> torch.Tensor:
    """upsample×r∘conv3×3 on a cell's neighbourhood stack: pp [B, h, w, 81,
    C] (f32) → fine [B, h, w, r, r, C] (f32). With ``kron_bf16``, one
    product against the bf16-rounded kron table (the bf16 kernels and the
    TPU kernel); else the two exact f32 9-tap passes."""
    b, h, w, _, c = pp.shape
    if kron_bf16:
        table = const(_ayx_bf16, r, device=pp.device)
        return torch.einsum('mk,bhwkc->bhwmc', table, pp).reshape(
            b, h, w, r, r, c)
    ay = const(_a2, r, device=pp.device)
    ax = const(_a2_dmajor, r, device=pp.device)
    t = torch.einsum('pa,bhwaxc->bhwpxc', ay, pp.reshape(b, h, w, 9, 9, c))
    return torch.einsum('qx,bhwpxc->bhwpqc', ax, t)


def seg_core_plain(P: torch.Tensor, a1: torch.Tensor, c1: torch.Tensor,
                   wp: torch.Tensor, bp: torch.Tensor, r: int) -> torch.Tensor:
    """Plain version of the kernel: P [B, h, w, 9, C] (taps ky·3+kx) →
    logits [B, h·r, w·r, nc] in P's dtype, rounded where the kernel rounds."""
    b, h, w, _, c = P.shape
    nc = wp.shape[1]
    pp = _neighbor_pp(P.reshape(b, h, w, 3, 3, c)).float()
    fine = phase_passes(pp, r, P.dtype == torch.bfloat16)  # [B,h,w,r,r,C]
    hidden = torch.relu(fine * a1.float() + c1.float())
    hidden = hidden.to(P.dtype).float()
    logits = hidden @ wp.to(P.dtype).float() + bp.float()
    return logits.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h * r, w * r, nc).to(P.dtype)


def _design(dtype: torch.dtype) -> str:
    """The design of the seg-head forward kernels (K2, K7) for ``dtype``:
    ``'mma_bf16'`` (tensor cores) for bf16, ``'simt_f32'`` (CUDA cores) for
    f32. Raises for any other dtype."""
    if dtype == torch.bfloat16:
        return 'mma_bf16'
    if dtype == torch.float32:
        return 'simt_f32'
    raise TypeError(f'the seg-head kernels take f32 or bf16, got {dtype}')


def check_shapes(P, wp, a1, c1, bp, r, what) -> str:
    """Validates a seg-head kernel's operands; returns their design."""
    design = _design(P.dtype)
    b, h, w, nine, c = P.shape
    nc = wp.shape[1]
    if nine != 9 or tuple(wp.shape) != (c, nc) or not 1 <= r <= 32 \
            or c % 16:
        raise ValueError(f'{what}: bad shapes P {tuple(P.shape)}, wp '
                         f'{tuple(wp.shape)}, r {r} (kernel: P [B, h, w, 9, '
                         f'C], 1 ≤ r ≤ 32, C % 16 == 0)')
    if not 1 <= nc <= NC_MAX:
        raise ValueError(f'{what}: the kernels take 1 to {NC_MAX} classes, '
                         f'got {nc}')
    if (a1.numel(), c1.numel(), bp.numel()) != (c, c, nc):
        raise ValueError(f'{what}: a1/c1 need {c} values and bp {nc}, got '
                         f'{a1.numel()}, {c1.numel()}, {bp.numel()}')
    return design


def _launch(P, a1, c1, wp, bp, r):
    design = check_shapes(P, wp, a1, c1, bp, r, 'seg_core')
    b, h, w, _, c = P.shape
    nc = wp.shape[1]
    dev = P.device
    f32 = dict(dtype=torch.float32, device=dev)
    P = _build.operand(P)
    wp = wp.to(P.dtype).contiguous()
    ay = const(_a2, r, device=dev)
    ax = const(_a2_dmajor, r, device=dev)
    a1, c1, bp = (t.to(**f32).contiguous() for t in (a1, c1, bp))
    out = torch.empty((b, h * r, w * r, nc), dtype=P.dtype, device=dev)
    _build.launch('seg_core', 'seg_head', 'seg_head_launch',
                  [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7, P, ay, ax, a1,
                  c1, wp, bp, out, b, h, w, c, r, nc,
                  int(P.dtype == torch.bfloat16), design=design)
    return out


def seg_core(P: torch.Tensor, a1: torch.Tensor, c1: torch.Tensor,
             wp: torch.Tensor, bp: torch.Tensor, r: int) -> torch.Tensor:
    """Fused phase passes + affine + ReLU + 1×1: P [B, h, w, 9, C] →
    [B, h·r, w·r, nc] (interior values; the 1-px border is pasted after):
    the op ``awseg::seg_core``, K2 on CUDA tensors, the plain version on
    CPU tensors."""
    return torch.ops.awseg.seg_core(P, a1, c1, wp, bp, r)


def coarse_partial_products(f: torch.Tensor,
                            kernel: torch.Tensor) -> torch.Tensor:
    """P = f·W1 per tap: f [B, h, w, Cin], kernel [3, 3, Cin, C] (HWIO) →
    [B, h, w, 9, C] (taps ky·3+kx), in f's dtype."""
    b, h, w, cin = f.shape
    c = kernel.shape[-1]
    wk = kernel.to(f.dtype).reshape(9, cin, c).permute(1, 0, 2)
    return (f.reshape(-1, cin) @ wk.reshape(cin, 9 * c)).reshape(b, h, w, 9, c)


def _paste_seg_borders(out, f, conv1_kernel, a1, c1b, wp, bp, r):
    """Overwrite the four 1-px border lines with exact zero-padded values."""
    dtype = out.dtype
    lines = conv1_border_lines(f, conv1_kernel, r)

    def head_tail(pre):  # [B, N, C] pre-BN conv1 (bias folded into c1b)
        hdn = torch.relu(pre.float() * a1.float() + c1b.float())
        return (hdn.to(dtype).float() @ wp.to(dtype).float()
                + bp.float()).to(dtype)

    out[:, 0] = head_tail(lines['top'])
    out[:, -1] = head_tail(lines['bot'])
    out[:, :, 0] = head_tail(lines['left'])
    out[:, :, -1] = head_tail(lines['right'])
    return out


def seg_head_fused(f: torch.Tensor, conv1_kernel: torch.Tensor,
                   conv1_bias: torch.Tensor, bn_scale, bn_bias, bn_mean,
                   bn_var, bn_eps: float, proj_kernel: torch.Tensor,
                   proj_bias: torch.Tensor, scale: int = 32) -> torch.Tensor:
    """Fused faithful seg head: conv3×3(upsample×scale(f)) → BN → ReLU →
    conv1×1, eval mode. f [B, h, w, Cin] NHWC, conv1_kernel [3, 3, Cin, C]
    and proj_kernel [1, 1, C, nc] in the JAX (HWIO) layout. Returns
    [B, h·scale, w·scale, nc] in f's dtype."""
    c1 = conv1_kernel.shape[-1]
    nc = proj_kernel.shape[-1]
    P = coarse_partial_products(f, conv1_kernel)
    a1, c1b = _bn_fold(conv1_bias, bn_scale, bn_bias, bn_mean, bn_var, bn_eps)
    wp = proj_kernel.reshape(c1, nc)
    out = seg_core(P, a1.float(), c1b.float(), wp, proj_bias, scale)
    return _paste_seg_borders(out, f, conv1_kernel, a1.float(), c1b.float(),
                              wp, proj_bias, scale)
