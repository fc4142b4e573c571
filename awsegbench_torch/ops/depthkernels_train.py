"""Fused faithful depth-head stage 1, train mode (counterpart of
``awsegbench/ops/depthkernels_train.py``).

The faithful depth head is ``conv3x3(upsample×r(f)) → BN → ReLU → dropout →
conv3x3 → BN → ReLU → conv1x1 → sigmoid``. Its stage 1, everything up to
and including the second conv, runs here:

* **BN1 batch statistics in the coarse domain**: ``seg_batch_stats`` of the
  seg head (``ops/headkernels_train.py``), on the same coarse partial
  products ``P [B, h, w, 9, C]``, border-exact.
* **The core** (:func:`d1_core_train`): the phase passes, the batch-stat
  affine, ReLU and the counter-hash dropout, writing the post-dropout hidden
  ``d1 [B, H, W, C]`` once (the op ``awseg::d1_core_train``). On CUDA
  tensors K9 (``csrc/depth_stage1_train.cu``); its gradient launches K10
  (recompute, regenerate the mask, write ``dpp`` and the sums of
  da1/dc1), then scatters ``dpp`` back to ``P`` (``neighbor_pp_adjoint``).
  It saves P, a1, c1 and the seed, never d1.
  K9 and K10 have the seg head's two designs: bf16 on the tensor cores
  (``mma_bf16``: K7's forward body storing the hidden, K8's backward body
  without the 1×1; C % 16 == 0) against the bf16-rounded kron table, as
  the TPU kernels round it; f32 on the CUDA cores (``simt_f32``: the exact
  two 9-tap passes). On CPU tensors it is :func:`d1_core_train_plain`
  under plain autograd, which rounds as the kernels do for the dtype.
* **Border lines**: d1's four outermost fine lines are recomputed from the
  exact zero-padded conv1 lines (``conv1_border_lines``) with the same affine
  and hash mask and pasted in place.
* **conv2** is a library convolution on d1, as the JAX package leaves it to
  XLA: d1 stays NHWC-contiguous and the conv gets its ``channels_last``
  NCHW view, so no layout copy of the 128-channel full-resolution field is
  made.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from ..parallel.collectives import global_rows, sync_sum
from .._device import const
from .headkernels import (_a2, _a2_dmajor, _ayx_bf16_k96, _design,
                          _neighbor_pp, coarse_partial_products)
from .headkernels_train import (_core_from_pp, _core_params, border_hidden,
                                dropout_keep_mask, kernel_seed,
                                seg_batch_stats, split_sums)
from .upconv import conv1_border_lines

__all__ = ['d1_core_train', 'd1_core_train_backward', 'd1_core_train_plain',
           'd1_core_train_backward_plain', 'depth_stage1_fused_train',
           'dropout_keep_mask']


# ---------------------------------------------------------------------------
# the core: plain version, kernels
# ---------------------------------------------------------------------------

def d1_core_train_plain(P, a1, c1, seed, rate: float, r: int):
    """Plain version of K9 (and, under autograd, of K10): P [B, h, w, 9, C]
    → d1 [B, h·r, w·r, C] in P's dtype."""
    b, h, w, _, c = P.shape
    pp = _neighbor_pp(P.reshape(b, h, w, 3, 3, c)).float()
    return _core_from_pp(pp, a1, c1, seed, rate, r, P.dtype,
                         kron_bf16=P.dtype == torch.bfloat16)


def d1_core_train_backward_plain(P, a1, c1, seed, dd1, rate: float, r: int):
    """Plain version of K10: (dpp [B, h, w, 81, C] in P's dtype, da1, dc1 in
    f32), the gradients of the core on its neighbourhood stack for the
    output gradient ``dd1``."""
    b, h, w, _, c = P.shape
    with torch.enable_grad():
        pp = _neighbor_pp(P.detach().reshape(b, h, w, 3, 3, c)).float()
        ins = [t.detach().float().requires_grad_() for t in (pp, a1, c1)]
        out = _core_from_pp(*ins, seed, rate, r, P.dtype,
                            kron_bf16=P.dtype == torch.bfloat16)
        dpp, da1, dc1 = torch.autograd.grad(out, ins, dd1)
    return dpp.to(P.dtype), da1, dc1


def _kernel_args(P, a1, c1, seed, r, what):
    """Validates a depth-core kernel's operands; returns their design and
    the operands the launch takes."""
    if P.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{what}: P must be f32 or bf16, got {P.dtype}')
    design = _design(P.dtype)
    b, h, w, nine, c = P.shape
    if nine != 9 or not 1 <= r <= 32 or c < 1:
        raise ValueError(f'{what}: bad shapes P {tuple(P.shape)}, r {r} '
                         f'(kernel: P [B, h, w, 9, C], 1 ≤ r ≤ 32)')
    if design == 'mma_bf16' and c % 16:
        raise ValueError(f'{what}: the bf16 kernels take C % 16 == 0, got '
                         f'C = {c}')
    if (a1.numel(), c1.numel()) != (c, c):
        raise ValueError(f'{what}: a1/c1 need {c} values')
    dev = P.device
    f32 = dict(dtype=torch.float32, device=dev)
    return design, (_build.operand(P), const(_a2, r, device=dev),
                    const(_a2_dmajor, r, device=dev),
                    *(t.detach().to(**f32).contiguous() for t in (a1, c1)),
                    kernel_seed(seed, dev, what))


def _launch_forward(P, a1, c1, seed, rate, r):
    design, (P, ay, ax, a1, c1, seed) = _kernel_args(P, a1, c1, seed, r,
                                                     'd1_core_train')
    b, h, w, _, c = P.shape
    thresh, inv_keep = _core_params(rate)
    out = torch.empty((b, h * r, w * r, c), dtype=P.dtype, device=P.device)
    _build.launch('d1_core_train', 'depth_stage1_train', 'd1_fwd_launch',
                  [ctypes.c_void_p] * 6 + [ctypes.c_uint, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_void_p]
                  + [ctypes.c_int] * 6, P, ay, ax, a1, c1, seed, thresh,
                  inv_keep, int(rate > 0.0), out, b, h, w, c, r,
                  int(P.dtype == torch.bfloat16), design=design)
    return out


def _launch_backward(P, a1, c1, seed, dd1, rate, r):
    design, (P, ay, ax, a1, c1, seed) = _kernel_args(
        P, a1, c1, seed, r, 'd1_core_train_backward')
    b, h, w, _, c = P.shape
    if tuple(dd1.shape) != (b, h * r, w * r, c):
        raise ValueError(f'd1_core_train_backward: dd1 {tuple(dd1.shape)}')
    dd1 = _build.operand(dd1.to(P.dtype))
    thresh, inv_keep = _core_params(rate)
    dpp = torch.empty((b, h, w, 81, c), dtype=P.dtype, device=P.device)
    part = torch.empty((b * h * w, 2 * c), dtype=torch.float32,
                       device=P.device)
    sums = torch.empty(2 * c, dtype=torch.float32, device=P.device)
    kron = const(_ayx_bf16_k96, r, device=P.device, dtype=torch.bfloat16)
    _build.launch('d1_core_train_backward', 'depth_stage1_train',
                  'd1_bwd_launch',
                  [ctypes.c_void_p] * 7 + [ctypes.c_uint, ctypes.c_float,
                                           ctypes.c_int]
                  + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6, P, ay, ax,
                  a1, c1, dd1, seed, thresh, inv_keep, int(rate > 0.0), dpp,
                  part, sums, kron, b, h, w, c, r,
                  int(P.dtype == torch.bfloat16), design=design)
    return dpp, sums


def d1_core_train_backward(P, a1, c1, seed, dd1, rate: float, r: int):
    """K10: (dpp, da1, dc1) for the output gradient dd1, the op
    ``awseg::d1_core_train_backward``. CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    dpp, sums = torch.ops.awseg.d1_core_train_backward(P, a1, c1, seed, dd1,
                                                       rate, r)
    return (dpp, *split_sums(sums, (a1, c1)))


def d1_core_train(P: torch.Tensor, a1: torch.Tensor, c1: torch.Tensor,
                  seed: torch.Tensor, rate: float, r: int) -> torch.Tensor:
    """Depth stage-1 core: phase passes → affine (a1, c1) → ReLU → hash
    dropout: P [B, h, w, 9, C] → d1 [B, h·r, w·r, C] (interior values; the
    1-px border is pasted after). ``seed`` is an int32 tensor on P's
    device. The op ``awseg::d1_core_train``: CUDA tensors launch K9 (K10
    and the scatter under autograd), CPU tensors take the plain version."""
    return torch.ops.awseg.d1_core_train(P, a1, c1, seed, rate, r)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def depth_stage1_fused_train(f: torch.Tensor, conv1_kernel: torch.Tensor,
                             conv1_bias: torch.Tensor, bn_scale: torch.Tensor,
                             bn_bias: torch.Tensor, bn_eps: float,
                             conv2_kernel: torch.Tensor, *, rate: float = 0.0,
                             seed: torch.Tensor | None = None,
                             scale: int = 32):
    """Train-mode fused depth-head stage 1:
    ``conv2_nobias(dropout(relu(BN_batch(conv3x3(upsample×scale(f))))))``.
    f [B, h, w, Cin] NHWC (h, w ≥ 2), kernels HWIO.

    Returns ``(h2 [B, H, W, c2], batch_mean [c1], batch_var [c1])``: h2 is
    conv2's bias-free output (the caller adds the bias and runs BN2, ReLU,
    the 1×1 and the sigmoid); mean (conv1's bias included) and var are the
    f32 batch statistics of the hidden (fast variance), for the caller to
    fold into BN1's running stats. Dropout keeps by the counter hash of
    ``seed`` (an int32 tensor)."""
    b, h, w, _ = f.shape
    r = scale
    if rate > 0.0 and seed is None:
        raise ValueError('dropout needs a seed')
    if seed is None:
        seed = torch.zeros((), dtype=torch.int32, device=f.device)

    P = coarse_partial_products(f, conv1_kernel)
    lines = conv1_border_lines(f, conv1_kernel, r)
    # batch-wide: summed over the data-parallel ranks (parallel.collectives)
    s_full, q_full = (sync_sum(t) for t in seg_batch_stats(P, r, lines))
    n = float(global_rows(b) * h * w * r * r)
    mean_nb = s_full / n                       # bias-free mean
    var = q_full / n - mean_nb * mean_nb
    a1 = bn_scale.float() * torch.rsqrt(var + bn_eps)
    c1b = bn_bias.float() - mean_nb * a1

    d1 = d1_core_train(P, a1, c1b, seed, rate, r)
    d1 = _paste_d1_borders(d1, lines, a1, c1b, rate, seed)
    # the NCHW view of NHWC d1 is channels_last: no layout copy
    h2 = F.conv2d(d1.permute(0, 3, 1, 2),
                  conv2_kernel.to(d1.dtype).permute(3, 2, 0, 1), padding=1)
    return (h2.permute(0, 2, 3, 1), mean_nb + conv1_bias.float(), var)


def _paste_d1_borders(d1, lines, a1, c1b, rate, seed):
    """Overwrite d1's four 1-px border lines with exact zero-padded values
    (BN1 batch affine, ReLU and the same hash dropout as the interior). The
    overwrite is in place, so the core gets no gradient there."""
    def dropped(side, pre):                   # [B, N, c1] bias-free conv1
        return border_hidden(side, pre, a1, c1b, rate, seed,
                             d1.shape[:3]).to(d1.dtype)

    d1[:, 0] = dropped('top', lines['top'])
    d1[:, -1] = dropped('bot', lines['bot'])
    d1[:, :, 0] = dropped('left', lines['left'])
    d1[:, :, -1] = dropped('right', lines['right'])
    return d1
