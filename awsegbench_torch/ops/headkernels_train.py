"""Fused faithful segmentation head, train mode (counterpart of
``awsegbench/ops/headkernels_train.py``).

``conv3x3(upsample×r(f)) → BN (batch statistics) → ReLU → dropout → 1×1``
without storing the full-resolution 256-channel hidden:

* **Batch statistics in the coarse domain** (:func:`seg_batch_stats`): the
  hidden is linear in the neighbourhood-stacked coarse partial products
  ``pp``, so its per-channel sum and sum of squares contract through the
  joint phase table's column sums and Gram matrix, with the four border
  fine lines swapped for their exact zero-padded values. Plain,
  differentiable torch: autograd through it is the batch-stat half of the
  BN-train backward.
* **Counter-hash dropout** (:func:`dropout_keep_mask`, :func:`_line_mask`):
  the keep bit is a pure hash of the element's position and a seed, the
  same bits as the JAX package's, so the forward kernel, the backward
  kernel, the border strips and the plain version draw one mask with no
  stored state.
* **The core** (:func:`seg_core_train`, the op ``awseg::seg_core_train``):
  on CUDA tensors K7 (``csrc/seg_head_train.cu``); its gradient launches
  K8 (recompute, regenerate the mask, write ``dpp`` and the sums of
  da1/dc1/dwp/dbp), then scatters ``dpp`` back to ``P``
  (:func:`neighbor_pp_adjoint`, ``csrc/pp_adjoint.cu``). It saves ``P``,
  a1, c1, wp, bp and the seed, never the hidden. K7 and K8 have K2's two
  designs (``headkernels._design``): bf16 on the tensor cores against the
  bf16-rounded kron table, as the TPU kernel rounds it, with the hash
  dropout in registers (K8 forms fine with K7's own code); f32 on the CUDA
  cores as two 9-tap passes. So forward and backward see one ReLU and one
  mask, as in the TPU kernels.
  On CPU tensors the core is :func:`seg_core_train_plain` under plain
  autograd, which rounds as the kernels do for the dtype. Class counts 1
  to 32 reach the kernels, which pad the class axis inside.

``P [B, h, w, 9, C]`` (taps ky·3+kx) is the port's layout of the coarse
partial products, as in ``ops/headkernels.py``; the JAX package's
``pp [B, h, w/chunk, 81, chunk·C]`` is its neighbourhood stack.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..parallel.collectives import global_rows, sync_sum
from .._device import const
from .headkernels import (_a2, _a2_dmajor, _ayx, _ayx_bf16_k96, _neighbor_pp,
                          check_shapes, coarse_partial_products, phase_passes)
from .upconv import conv1_border_lines

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# counter-based dropout mask (uint32 arithmetic in int64 tensors)
# ---------------------------------------------------------------------------

def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h·m) mod 2³² for h in [0, 2³²), with no int64 overflow: the two
    16-bit halves of m multiply separately."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """The lowbias32 mixer on uint32 values held in int64 (so ``>>`` is the
    logical shift JAX uses on int32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 15)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def pixel_index(y, x, c, W: int, C: int):
    """Per-image element index ``(y·W + x)·C + c``, the hash input
    (< 2³¹ at every supported resolution)."""
    return (y * W + x) * C + c


def image_seed(seed: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Image b's seed, ``seed ^ mix32((b0 + b)·M1)``, as a uint32 value in
    int64. ``seed`` is one int32, or two: (seed, b0), where b0 is the global
    index of the batch's first row (a data-parallel rank's rows hash as
    the global batch's do); b0 is 0 for one."""
    s = seed.reshape(-1).to(torch.int64)
    b = b.to(torch.int64) + (s[1] if s.numel() > 1 else 0)
    return (s[0] & _U32) ^ _mix32(_mul32(b & _U32, _M1))


def kernel_seed(seed: torch.Tensor, device: torch.device,
                what: str) -> torch.Tensor:
    """The kernels' seed operand: int32 (seed, b0) on ``device`` from a
    seed of one value (b0 = 0) or two (:func:`image_seed`)."""
    if seed.numel() not in (1, 2) or seed.device != device:
        raise ValueError(f'{what}: seed must be one or two int32 (seed, '
                         f'first row) on P\'s device')
    s = seed.detach().to(torch.int32).reshape(-1)
    return (s if s.numel() == 2 else F.pad(s, (0, 1))).contiguous()


def hash_keep(idx: torch.Tensor, bseed: torch.Tensor, rate: float):
    """Keep iff ``u32(mix32(idx ^ seed)) >= round(rate·2³²)``."""
    return _mix32(idx ^ bseed) >= _core_params(rate)[0]


def dropout_keep_mask(shape, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """[B, H, W, C] bool keep mask on the seed's device (one image at a
    time, which bounds the int64 temporaries)."""
    B, H, W, C = shape
    dev = seed.device
    ar = functools.partial(torch.arange, dtype=torch.int64, device=dev)
    idx = pixel_index(ar(H)[:, None, None], ar(W)[None, :, None],
                      ar(C)[None, None, :], W, C)
    return torch.stack([hash_keep(idx, image_seed(seed, ar(1) + b), rate)
                        for b in range(B)])


def _line_mask(side: str, B: int, H: int, W: int, c1: int,
               seed: torch.Tensor, rate: float) -> torch.Tensor:
    """[B, N, c1] keep mask of one 1-px border line of the full-res field
    (top/bot: y fixed, N walks x; left/right: x fixed, N walks y)."""
    ar = functools.partial(torch.arange, dtype=torch.int64, device=seed.device)
    bseed = image_seed(seed, ar(B))[:, None, None]
    c = ar(c1)[None, None, :]
    if side in ('top', 'bot'):
        y = 0 if side == 'top' else H - 1
        return hash_keep(pixel_index(y, ar(W)[None, :, None], c, W, c1),
                         bseed, rate)
    x = 0 if side == 'left' else W - 1
    return hash_keep(pixel_index(ar(H)[None, :, None], x, c, W, c1),
                     bseed, rate)


def _core_params(rate: float) -> tuple[int, float]:
    """(uint32 drop threshold, 1/keep)."""
    keep = 1.0 - rate
    thresh = min(int(round(rate * 4294967296.0)), 4294967295)
    return thresh, (1.0 / keep if keep > 0.0 else 0.0)


# ---------------------------------------------------------------------------
# batch statistics in the coarse domain
# ---------------------------------------------------------------------------

def _edge_rows(r: int, edge: str) -> np.ndarray:
    """The [r, 81] rows of the joint table on one border fine line."""
    a = _ayx(r)
    return {'top': a[0:r], 'bot': a[(r - 1) * r:r * r],
            'left': a[0::r], 'right': a[r - 1::r]}[edge]


def _edge_colsum(r: int, edge: str) -> np.ndarray:
    return _edge_rows(r, edge).sum(axis=0)


def _edge_gram(r: int, edge: str) -> np.ndarray:
    rows = _edge_rows(r, edge)
    return (rows.T @ rows).astype(np.float32)


def _gram(r: int) -> np.ndarray:
    a = _ayx(r)
    return (a.T @ a).astype(np.float32)


def _colsum(r: int) -> np.ndarray:
    return _ayx(r).sum(axis=0)


def _corner_rows(r: int) -> np.ndarray:
    a = _ayx(r)
    return a[[0, r - 1, (r - 1) * r, r * r - 1]]


def _sum_sq(x, dims):
    xf = x.float()
    return xf.sum(dims), (xf * xf).sum(dims)


def seg_batch_stats(P: torch.Tensor, r: int,
                    lines: dict[str, torch.Tensor]):
    """(sum, sum of squares) per channel of the bias-free full-resolution
    hidden ``conv3x3(upsample×r(f))``, border-exact, f32.

    ``P [B, h, w, 9, C]`` are the coarse partial products and ``lines`` the
    exact border lines (``conv1_border_lines``). Needs h, w ≥ 2."""
    b, h, w, _, c = P.shape
    dev = P.device
    pp = _neighbor_pp(P.reshape(b, h, w, 3, 3, c)).float()   # [B,h,w,81,C]
    tab = functools.partial(const, device=dev)

    # the interior formula over all cells, its (wrong) border lines included
    s_all = torch.einsum('a,bhwak->k', tab(_colsum, r), pp)
    q_all = (pp * torch.einsum('ax,bhwxk->bhwak', tab(_gram, r), pp)).sum(
        (0, 1, 2, 3))

    # the interior formula's values on the four border fine lines
    def edge_sums(edge, cells):                       # cells [..., 81, C]
        csum, g = tab(_edge_colsum, r, edge), tab(_edge_gram, r, edge)
        s = torch.einsum('a,...ak->k', csum, cells)
        q = (cells * torch.einsum('ax,...xk->...ak', g, cells)).reshape(
            -1, c).sum(0)
        return s, q

    s_kb = torch.zeros(c, device=dev)
    q_kb = torch.zeros(c, device=dev)
    for edge, cells in (('top', pp[:, 0]), ('bot', pp[:, -1]),
                        ('left', pp[:, :, 0]), ('right', pp[:, :, -1])):
        s_e, q_e = edge_sums(edge, cells)
        s_kb, q_kb = s_kb + s_e, q_kb + q_e
    # the corners lie on two lines each: counted twice above, once here
    corners = torch.stack([pp[:, 0, 0], pp[:, 0, -1], pp[:, -1, 0],
                           pp[:, -1, -1]], dim=1)           # [B, 4, 81, C]
    v = torch.einsum('ia,biak->bik', tab(_corner_rows, r), corners)
    s_kb = s_kb - v.sum((0, 1))
    q_kb = q_kb - (v * v).sum((0, 1))

    # the true zero-padded border values
    s_eb = torch.zeros(c, device=dev)
    q_eb = torch.zeros(c, device=dev)
    for name in ('top', 'bot', 'left', 'right'):
        s_i, q_i = _sum_sq(lines[name], (0, 1))
        s_eb, q_eb = s_eb + s_i, q_eb + q_i
    for cv in (lines['top'][:, 0], lines['top'][:, -1],
               lines['bot'][:, 0], lines['bot'][:, -1]):
        s_i, q_i = _sum_sq(cv, (0,))
        s_eb, q_eb = s_eb - s_i, q_eb - q_i
    return s_all - s_kb + s_eb, q_all - q_kb + q_eb


# ---------------------------------------------------------------------------
# the core: plain version, kernels
# ---------------------------------------------------------------------------

def _core_from_pp(pp, a1, c1, seed, rate, r, dtype, wp=None, bp=None,
                  kron_bf16=False):
    """The core on the neighbourhood stack pp [B, h, w, 81, C] (f32):
    phase passes (:func:`phase_passes`, the bf16 kron table with
    ``kron_bf16``) → affine (a1, c1) → ReLU → hash dropout, rounded to
    ``dtype`` where the kernels round, then the 1×1 (wp, bp) when given.
    Returns [B, h·r, w·r, nc] (the seg core's logits) or, without wp, the
    post-dropout hidden [B, h·r, w·r, C] (the depth core's d1)."""
    b, h, w, _, c = pp.shape
    fine = phase_passes(pp, r, kron_bf16)                  # [B,h,w,r,r,C]
    u = torch.relu(fine * a1.float() + c1.float())
    if rate > 0.0:
        keep = dropout_keep_mask((b, h * r, w * r, c), seed, rate)
        keep = keep.reshape(b, h, r, w, r, c).permute(0, 1, 3, 2, 4, 5)
        u = torch.where(keep, u * _core_params(rate)[1], 0.0)
    out = u.to(dtype)
    if wp is not None:
        out = out.float() @ wp.to(dtype).float() + bp.float()
    return out.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h * r, w * r, out.shape[-1]).to(dtype)


def seg_core_train_plain(P, a1, c1, wp, bp, seed, rate: float, r: int):
    """Plain version of K7 (and, under autograd, of K8): P [B, h, w, 9, C]
    → logits [B, h·r, w·r, nc] in P's dtype."""
    b, h, w, _, c = P.shape
    pp = _neighbor_pp(P.reshape(b, h, w, 3, 3, c)).float()
    return _core_from_pp(pp, a1, c1, seed, rate, r, P.dtype, wp, bp,
                         kron_bf16=P.dtype == torch.bfloat16)


def seg_core_train_backward_plain(P, a1, c1, wp, bp, seed, dy, rate: float,
                                  r: int):
    """Plain version of K8: (dpp [B, h, w, 81, C] in P's dtype, da1, dc1,
    dwp, dbp in f32), the gradients of the core on its neighbourhood stack
    for the output gradient ``dy``: autograd through the forward's plain
    version, which forms fine as K7 and K8 do for the dtype (the bf16 kron
    table in bf16)."""
    b, h, w, _, c = P.shape
    with torch.enable_grad():
        pp = _neighbor_pp(P.detach().reshape(b, h, w, 3, 3, c)).float()
        ins = [t.detach().float().requires_grad_() for t in (pp, a1, c1, wp, bp)]
        out = _core_from_pp(*ins[:3], seed, rate, r, P.dtype, *ins[3:],
                            kron_bf16=P.dtype == torch.bfloat16)
        dpp, *rest = torch.autograd.grad(out, ins, dy)
    return (dpp.to(P.dtype), *rest)


def _neighbor_pp_adjoint(dpp: torch.Tensor) -> torch.Tensor:
    """Transpose of ``_neighbor_pp``: dpp [B, h, w, 81, C] → dP
    [B, h, w, 9, C] in f32, each clamped neighbour's gradient added back to
    the coarse cell it was gathered from."""
    b, h, w, _, c = dpp.shape
    g = dpp.float().reshape(b, h, w, 3, 3, 3, 3, c)      # ky, dy, dx, kx
    g = g.permute(0, 1, 4, 2, 5, 3, 6, 7)                # b,h,dy,w,dx,ky,kx,C
    g = _shift_gather_adjoint(g, 3)                      # b,h,dy,w,ky,kx,C
    g = _shift_gather_adjoint(g, 1)                      # b,h,w,ky,kx,C
    return g.reshape(b, h, w, 9, c)


def _shift_gather_adjoint(g: torch.Tensor, axis: int) -> torch.Tensor:
    """Transpose of ``upconv._shift_gather`` along ``axis``: g has the
    stacked {-1, 0, +1} shifts at ``axis + 1``; sums them back."""
    left, mid, right = g.unbind(axis + 1)
    n = mid.shape[axis]
    out = mid.clone()
    if n > 1:
        out.narrow(axis, 0, n - 1).add_(left.narrow(axis, 1, n - 1))
        out.narrow(axis, 1, n - 1).add_(right.narrow(axis, 0, n - 1))
    out.narrow(axis, 0, 1).add_(left.narrow(axis, 0, 1))
    out.narrow(axis, n - 1, 1).add_(right.narrow(axis, n - 1, 1))
    return out


def _launch_pp_adjoint(dpp):
    if dpp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'neighbor_pp_adjoint: dpp must be f32 or bf16, got '
                        f'{dpp.dtype}')
    if dpp.dim() != 5 or dpp.shape[3] != 81 or 0 in dpp.shape:
        raise ValueError(f'neighbor_pp_adjoint: bad shape dpp '
                         f'{tuple(dpp.shape)} (kernel: [B, h, w, 81, C])')
    dpp = dpp.contiguous()
    b, h, w, _, c = dpp.shape
    out = torch.empty((b, h, w, 9, c), dtype=dpp.dtype, device=dpp.device)
    _build.launch('neighbor_pp_adjoint', 'pp_adjoint', 'pp_adjoint_launch',
                  [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5, dpp, out, b, h,
                  w, c, int(dpp.dtype == torch.bfloat16))
    return out


def neighbor_pp_adjoint(dpp: torch.Tensor) -> torch.Tensor:
    """dpp [B, h, w, 81, C] → dP [B, h, w, 9, C] in dpp's dtype (the train
    backwards' gradient of P, which dpp shares its dtype with): the
    transpose of the neighbourhood gather, the op
    ``awseg::neighbor_pp_adjoint``. CUDA tensors launch
    ``csrc/pp_adjoint.cu``, which sums in f32 in the plain version's
    order; CPU tensors take :func:`_neighbor_pp_adjoint`."""
    return torch.ops.awseg.neighbor_pp_adjoint(dpp)


def _kernel_args(P, a1, c1, wp, bp, seed, r, what):
    design = check_shapes(P, wp, a1, c1, bp, r, what)
    dev = P.device
    f32 = dict(dtype=torch.float32, device=dev)
    return design, (_build.operand(P), const(_a2, r, device=dev),
                    const(_a2_dmajor, r, device=dev),
                    *(t.detach().to(**f32).contiguous() for t in (a1, c1)),
                    wp.detach().to(P.dtype).contiguous(),
                    bp.detach().to(**f32).contiguous(),
                    kernel_seed(seed, dev, what))


# pointers (8), thresh, 1/keep, dropout on; then the forward's out or the
# backward's dpp, part, sums; B, h, w, C, r, nc, bf16
_HEAD = [ctypes.c_void_p] * 8 + [ctypes.c_uint, ctypes.c_float, ctypes.c_int]
_TAIL = [ctypes.c_int] * 7


def _launch_forward(P, a1, c1, wp, bp, seed, rate, r):
    design, args = _kernel_args(P, a1, c1, wp, bp, seed, r, 'seg_core_train')
    P = args[0]
    b, h, w, _, c = P.shape
    nc = wp.shape[1]
    thresh, inv_keep = _core_params(rate)
    out = torch.empty((b, h * r, w * r, nc), dtype=P.dtype, device=P.device)
    _build.launch('seg_core_train', 'seg_head_train', 'seg_train_fwd_launch',
                  _HEAD + [ctypes.c_void_p] + _TAIL, *args, thresh, inv_keep,
                  int(rate > 0.0), out, b, h, w, c, r, nc,
                  int(P.dtype == torch.bfloat16), design=design)
    return out


def _launch_backward(P, a1, c1, wp, bp, seed, dy, rate, r):
    design, args = _kernel_args(P, a1, c1, wp, bp, seed, r,
                                'seg_core_train_backward')
    P = args[0]
    b, h, w, _, c = P.shape
    nc = wp.shape[1]
    if tuple(dy.shape) != (b, h * r, w * r, nc):
        raise ValueError(f'seg_core_train_backward: dy {tuple(dy.shape)}')
    dy = dy.to(P.dtype).contiguous()
    thresh, inv_keep = _core_params(rate)
    cols = 2 * c + nc * c + nc
    dpp = torch.empty((b, h, w, 81, c), dtype=P.dtype, device=P.device)
    part = torch.empty((b * h * w, cols), dtype=torch.float32, device=P.device)
    sums = torch.empty(cols, dtype=torch.float32, device=P.device)
    kron = const(_ayx_bf16_k96, r, device=P.device, dtype=torch.bfloat16)
    _build.launch('seg_core_train_backward', 'seg_head_train',
                  'seg_train_bwd_launch',
                  _HEAD + [ctypes.c_void_p] * 4 + _TAIL, *args[:6], dy,
                  args[7], thresh, inv_keep, int(rate > 0.0), dpp, part,
                  sums, kron, b, h, w, c, r, nc,
                  int(P.dtype == torch.bfloat16), design=design)
    return dpp, sums


def split_sums(sums: torch.Tensor, like) -> tuple:
    """K8's (K10's) column sums, the f32 gradients of a1, c1 (wp, bp),
    parted in the shapes of the tensors ``like``."""
    return tuple(g.view_as(t) for g, t in
                 zip(sums.split([t.numel() for t in like]), like))


def seg_core_train_backward(P, a1, c1, wp, bp, seed, dy, rate: float, r: int):
    """K8: (dpp, da1, dc1, dwp, dbp) for the output gradient dy, the op
    ``awseg::seg_core_train_backward``. CUDA tensors launch the kernel,
    CPU tensors take the plain version."""
    dpp, sums = torch.ops.awseg.seg_core_train_backward(
        P, a1, c1, wp, bp, seed, dy, rate, r)
    return (dpp, *split_sums(sums, (a1, c1, wp, bp)))


def seg_core_train(P: torch.Tensor, a1: torch.Tensor, c1: torch.Tensor,
                   wp: torch.Tensor, bp: torch.Tensor, seed: torch.Tensor,
                   rate: float, r: int) -> torch.Tensor:
    """Train core: phase passes → affine (a1, c1) → ReLU → hash dropout →
    1×1: P [B, h, w, 9, C] → [B, h·r, w·r, nc] (interior values; the 1-px
    border is pasted after). ``seed`` is an int32 tensor on P's device.
    The op ``awseg::seg_core_train``: CUDA tensors launch K7 (K8 and the
    scatter under autograd), CPU tensors take the plain version."""
    return torch.ops.awseg.seg_core_train(P, a1, c1, wp, bp, seed, rate, r)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def seg_head_fused_train(f: torch.Tensor, conv1_kernel: torch.Tensor,
                         conv1_bias: torch.Tensor, bn_scale: torch.Tensor,
                         bn_bias: torch.Tensor, bn_eps: float,
                         proj_kernel: torch.Tensor, proj_bias: torch.Tensor,
                         *, rate: float = 0.0,
                         seed: torch.Tensor | None = None, scale: int = 32):
    """Train-mode fused faithful seg head:
    ``conv3x3(upsample×scale(f)) → BN(batch stats) → ReLU → dropout(rate)
    → conv1x1``. f [B, h, w, Cin] NHWC (h, w ≥ 2), kernels HWIO.

    Returns ``(out [B, H, W, nc], batch_mean [c1], batch_var [c1])``: the
    f32 batch statistics of the hidden (fast variance), for the caller to
    fold into the running stats. Dropout keeps by the counter hash of
    ``seed`` (an int32 tensor)."""
    b, h, w, _ = f.shape
    c1 = conv1_kernel.shape[-1]
    nc = proj_kernel.shape[-1]
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

    wp = proj_kernel.reshape(c1, nc)
    out = seg_core_train(P, a1, c1b, wp, proj_bias, seed, rate, r)
    out = _paste_seg_borders_train(out, lines, a1, c1b, wp, proj_bias, rate,
                                   seed)
    return out, mean_nb + conv1_bias.float(), var


def border_hidden(side, pre, a1, c1b, rate, seed, shape):
    """The post-dropout hidden [B, N, c1] (f32) on one 1-px border line of
    the full-resolution field ``shape`` (B, H, W): BN batch-stat affine,
    ReLU and the interior's hash dropout on the bias-free pre-BN conv1
    values ``pre``."""
    hdn = torch.relu(pre.float() * a1 + c1b)
    if rate > 0.0:
        keep = _line_mask(side, *shape, a1.shape[-1], seed, rate)
        hdn = torch.where(keep, hdn / (1.0 - rate), 0.0)
    return hdn


def _paste_seg_borders_train(out, lines, a1, c1b, wp, bp, rate, seed):
    """Overwrite the four 1-px border lines with exact zero-padded values
    (BN batch-stat affine, and the same hash dropout as the interior). The
    overwrite is in place, so the core gets no gradient there."""
    dtype = out.dtype

    def head_tail(name, pre):  # [B, N, c1] bias-free pre-BN conv1
        hdn = border_hidden(name, pre, a1, c1b, rate, seed, out.shape[:3])
        return (hdn.to(dtype).float() @ wp.to(dtype).float()
                + bp.float()).to(dtype)

    out[:, 0] = head_tail('top', lines['top'])
    out[:, -1] = head_tail('bot', lines['bot'])
    out[:, :, 0] = head_tail('left', lines['left'])
    out[:, :, -1] = head_tail('right', lines['right'])
    return out
