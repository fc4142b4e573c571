"""Fused faithful segmentation head, eval mode (counterpart of
``awsegbench/ops/headkernels.py``).

The faithful SegFormer seg head is ``upsample×r → conv3×3 → BN → ReLU →
conv1×1``. Around the kernel, in plain torch as in the JAX package:

* the coarse partial products ``P = f·W1`` (one matmul on the coarse grid),
* the fold of conv bias + eval BN into one affine (``_bn_fold``),
* the exact 1-px border lines (``_paste_seg_borders``), where the conv's
  zero padding differs from the clamped interior formula.

The core, ``seg_core``, turns ``P`` into full-resolution logits without
storing the full-resolution 256-channel hidden: on a CUDA tensor it launches
``csrc/seg_head.cu``; on a CPU tensor it runs :func:`seg_core_plain`, the
``_neighbor_pp`` composition with the phase tables ``Ay``/``Ax`` (the two
factors of the TPU kernel's ``kron(Ay, Ax)``).

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


def seg_core_plain(P: torch.Tensor, a1: torch.Tensor, c1: torch.Tensor,
                   wp: torch.Tensor, bp: torch.Tensor, r: int) -> torch.Tensor:
    """Plain version of the kernel: P [B, h, w, 9, C] (taps ky·3+kx) →
    logits [B, h·r, w·r, nc] in P's dtype, rounded where the kernel rounds."""
    b, h, w, _, c = P.shape
    nc = wp.shape[1]
    ay = const(_a2, r, device=P.device)
    ax = const(_a2_dmajor, r, device=P.device)
    pp = _neighbor_pp(P.reshape(b, h, w, 3, 3, c)).float()
    pp = pp.reshape(b, h, w, 9, 9, c)                      # [.., a, b, C]
    t = torch.einsum('pa,bhwaxc->bhwpxc', ay, pp)         # y-pass
    fine = torch.einsum('qx,bhwpxc->bhwpqc', ax, t)        # [B,h,w,r,r,C]
    hidden = torch.relu(fine * a1.float() + c1.float())
    hidden = hidden.to(P.dtype).float()
    logits = hidden @ wp.to(P.dtype).float() + bp.float()
    return logits.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h * r, w * r, nc).to(P.dtype)


def _launch(P, a1, c1, wp, bp, r):
    if P.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'seg_core: P must be f32 or bf16, got {P.dtype}')
    b, h, w, nine, c = P.shape
    nc = wp.shape[1]
    if nine != 9 or tuple(wp.shape) != (c, nc) or not 1 <= r <= 32 \
            or c % 16:
        raise ValueError(f'seg_core: bad shapes P {tuple(P.shape)}, wp '
                         f'{tuple(wp.shape)}, r {r} (kernel: r ≤ 32, C % 16 '
                         f'== 0)')
    if nc != 19:
        raise ValueError(f'seg_core: the CUDA kernel is built for 19 '
                         f'classes, got {nc}')
    if (a1.numel(), c1.numel(), bp.numel()) != (c, c, nc):
        raise ValueError(f'seg_core: a1/c1 need {c} values and bp {nc}, got '
                         f'{a1.numel()}, {c1.numel()}, {bp.numel()}')
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (P, a1, c1, wp, bp)):
        raise NotImplementedError('seg_core: the CUDA kernel is eval only')
    dev = P.device
    f32 = dict(dtype=torch.float32, device=dev)
    P = P.contiguous()
    wp = wp.to(P.dtype).contiguous()
    ay = const(_a2, r, device=dev)
    ax = const(_a2_dmajor, r, device=dev)
    a1, c1, bp = (t.to(**f32).contiguous() for t in (a1, c1, bp))
    out = torch.empty((b, h * r, w * r, nc), dtype=P.dtype, device=dev)
    lib = _build.load('seg_head')
    lib.seg_head_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.seg_head_launch.restype = ctypes.c_int
    rc = lib.seg_head_launch(
        _build.ptr(P), _build.ptr(ay), _build.ptr(ax), _build.ptr(a1),
        _build.ptr(c1), _build.ptr(wp), _build.ptr(bp), _build.ptr(out),
        b, h, w, c, r, nc, int(P.dtype == torch.bfloat16),
        _build.stream_ptr(P))
    _build.check(lib, rc, 'seg_core')
    seg_core.launches += 1
    return out


def seg_core(P: torch.Tensor, a1: torch.Tensor, c1: torch.Tensor,
             wp: torch.Tensor, bp: torch.Tensor, r: int) -> torch.Tensor:
    """Fused phase passes + affine + ReLU + 1×1: P [B, h, w, 9, C] →
    [B, h·r, w·r, nc] (interior values; the 1-px border is pasted after).
    CUDA tensors launch the kernel, CPU tensors take the plain version."""
    if P.is_cuda:
        return _launch(P, a1, c1, wp, bp, r)
    return seg_core_plain(P, a1, c1, wp, bp, r)


seg_core.launches = 0


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
