"""Prediction heads (counterpart of ``awsegbench/models/heads.py``).

Submodules are named after the Flax scopes (``Conv_0``, ``BatchNorm_0``, …)
so ``convert.flax_to_torch`` maps a Flax variable tree onto them name for
name. Public tensors are NHWC like the JAX package; the library convs run
on NCHW views. Train mode is the module's ``training`` flag
(``model.train()``), as the JAX modules take ``train=True``.

Parity notes:

* BN eval mode uses the running statistics with eps 1e-5, computed as Flax
  does: ``(x − mean)·(rsqrt(var + eps)·scale) + bias`` in the promoted
  dtype of x and the parameters. With the residual add and the ReLU that
  follow it, it is one ``ops.bn_act`` call: K12 on the card (f32
  arithmetic, rounded once), the composition op for op on the CPU. Its
  buffers are ``running_mean`` and ``running_var``; there is no
  ``num_batches_tracked``.
* BN train mode is Flax ``nn.BatchNorm``'s: f32 batch statistics by the
  fast variance ``E[x²] − E[x]²`` (clipped at 0), the normalisation in f32
  and the result in the promoted dtype; with the residual add and the ReLU
  that follow it, it is one ``ops.bn_train`` call with a registered
  gradient: K13 and K14 on the card (f32 arithmetic, rounded once), the
  composition op for op and the gradient's formula on the CPU. The
  running statistics are updated as ``0.9·old + 0.1·batch`` with the
  *biased* variance, where ``old`` is taken in the parameters' dtype (the
  compute dtype under a bf16 policy, as the JAX step casts
  ``batch_stats``) and the result kept in f32. Torch's ``F.batch_norm``
  would update with the unbiased variance.
* Padding is torch-style symmetric, ``d·(k−1)/2`` per side, for every
  ``ConvBNReLU`` (``heads.py:176-186`` in the JAX package pads that way on
  purpose: Flax ``'SAME'`` at stride 2 pads (0, 1) on even inputs). Stride-1
  ``'SAME'`` convs are the same symmetric padding.
* Under a data-parallel mesh (``parallel.collectives.data_parallel``),
  BN's train-mode statistics and the fused heads' batch sums are the
  global batch's, summed over the ranks (padded rows count, as in the JAX
  step), and the dropout hashes each row by its global index.
* Under tensor parallelism (``parallel/tensor.py``) every parameter
  these heads hand to a kernel (``hwio(...)``, the biases, BN's scale and
  bias) is read gathered to full size, so K2 and K7–K10 launch exactly as
  on one process; the dropout seeds read the data axis's rows, the same
  on every rank of the model group.
* The heads' dropout (rate 0.1) is the counter-hash mask of
  ``ops/headkernels_train.py`` on every path, drawn from an int32 seed per
  head; the JAX package's unfused paths use Flax ``nn.Dropout`` there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .._device import const
from ..ops.bn_act import bn_act
from ..ops.bn_train import MEAN, VAR, bn_train
from ..ops.depthkernels_train import depth_stage1_fused_train
from ..ops.headkernels import seg_head_fused
from ..ops.headkernels_train import dropout_keep_mask, seg_head_fused_train
from ..ops.upconv import upsample_conv3x3
from ..parallel.collectives import active_mesh, first_row

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A Conv2d weight in the JAX (kH, kW, Cin, Cout) layout."""
    return conv.weight.permute(2, 3, 1, 0)


class BatchNorm(nn.Module):
    """Batch norm over channel dim 1 (NCHW), Flax semantics in both modes."""

    def __init__(self, c: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM) -> None:
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None,
                relu: bool = False) -> torch.Tensor:
        """BN of x, then ``+ residual`` where given, then the ReLU where
        ``relu`` is set: one ``bn_train`` in train mode (K13, and K14 under
        autograd, on the card), one ``bn_act`` in eval mode (K12)."""
        if self.training:
            y, stats = bn_train(x, self.weight, self.bias, self.eps, residual,
                                relu)
            self.set_stats(stats[MEAN], stats[VAR])
            return y
        return bn_act(x, self.running_mean, self.running_var, self.weight,
                      self.bias, self.eps, residual, relu)

    @torch.no_grad()
    def set_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold f32 batch statistics into the running ones (Flax's update,
        also ``BatchNormParams(set_stats=...)`` for the fused head)."""
        # the scale's dtype and device, read without gathering a scale
        # sharded over the model axis (parallel/tensor.py)
        w = self._parameters['weight']
        m, cdt = self.momentum, w.dtype
        # JAX casts the Python momentum to the stats' dtype before the
        # product (a weak-typed scalar); torch would multiply in f32. A
        # cached device constant: a fresh copy would wait for the card.
        m_c = const(float, m, device=w.device, dtype=cdt)
        for buf, new in ((self.running_mean, mean), (self.running_var, var)):
            buf.copy_(buf.to(cdt) * m_c + (1.0 - m) * new.detach())


def rank_seed(seed: torch.Tensor | None, b: int) -> torch.Tensor | None:
    """A dropout seed for this rank's ``b`` rows: under a data-parallel
    mesh, (seed, global index of the first row), so that each row's mask
    is the one it has in the global batch (``ops.headkernels_train.
    image_seed``); else ``seed``."""
    if seed is None or active_mesh() is None:
        return seed
    return torch.stack([seed.reshape(()).to(torch.int32),
                        const(int, first_row(b), device=seed.device,
                              dtype=torch.int32)])


def hash_dropout(x: torch.Tensor, seed: torch.Tensor,
                 rate: float) -> torch.Tensor:
    """Dropout of an NCHW tensor by the counter-hash mask of ``seed`` over
    its NHWC positions (the fused kernels' mask)."""
    keep = dropout_keep_mask(nchw_to_nhwc(x).shape, seed, rate)
    return torch.where(nhwc_to_nchw(keep), x / (1.0 - rate), 0.0)


def conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
         groups: int = 1, bias: bool = True) -> nn.Conv2d:
    """Conv2d with symmetric padding d·(k−1)/2 per side."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                     dilation=dilation, groups=groups, bias=bias)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1,
                 use_relu: bool = True) -> None:
        super().__init__()
        self.Conv_0 = conv(cin, cout, kernel_size, stride, dilation, bias=False)
        self.BatchNorm_0 = BatchNorm(cout)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NCHW
        return self.BatchNorm_0(self.Conv_0(x), relu=self.use_relu)


class DepthEstimationHead(nn.Module):
    """conv3×3 → BN → ReLU → dropout(0.1) → conv3×3 → BN → ReLU → conv1×1 →
    sigmoid.

    With ``upsample_scale``, the input is the coarse field and the first
    conv is fused with the ×scale bilinear upsample: ``upsample_conv3x3`` in
    eval mode; in train mode (scale ≥ 4, features at least 2×2) stage 1
    runs as ``depth_stage1_fused_train`` (K9/K10 on the card), then BN2,
    ReLU, the 1×1 and the sigmoid in plain torch. Without it every conv is a
    library conv. Train mode needs the dropout ``seed``; the dropout (the
    identity in eval) is the counter-hash mask on every path."""

    def __init__(self, cin: int, hidden_channels: int = 256,
                 out_channels: int = 1, dropout: float = 0.1) -> None:
        super().__init__()
        c1, c2 = hidden_channels, hidden_channels // 2
        self.Conv_0 = conv(cin, c1, 3)
        self.BatchNorm_0 = BatchNorm(c1)
        self.Conv_1 = conv(c1, c2, 3)
        self.BatchNorm_1 = BatchNorm(c2)
        self.Conv_2 = conv(c2, out_channels, 1)
        self.dropout = dropout

    def forward(self, features: torch.Tensor,
                upsample_scale: int | None = None,
                seed: torch.Tensor | None = None) -> torch.Tensor:
        """features NHWC → depth NHWC [B, H', W', 1]; ``seed`` is an int32
        tensor."""
        bn0 = self.BatchNorm_0
        if self.training and seed is None:
            raise ValueError('DepthEstimationHead: train mode needs the '
                             'dropout seed')
        seed = rank_seed(seed, features.shape[0])
        if (self.training and upsample_scale is not None
                and upsample_scale >= 4 and min(features.shape[1:3]) >= 2):
            h2, mean, var = depth_stage1_fused_train(
                features, hwio(self.Conv_0), self.Conv_0.bias, bn0.weight,
                bn0.bias, bn0.eps, hwio(self.Conv_1), rate=self.dropout,
                seed=seed, scale=upsample_scale)
            bn0.set_stats(mean, var)
            x = nhwc_to_nchw(h2 + self.Conv_1.bias.to(h2.dtype))
        else:
            if upsample_scale is not None:
                x = nhwc_to_nchw(upsample_conv3x3(features, hwio(self.Conv_0),
                                                  self.Conv_0.bias,
                                                  scale=upsample_scale))
            else:
                x = self.Conv_0(nhwc_to_nchw(features))
            x = bn0(x, relu=True)
            if self.training:
                x = hash_dropout(x, seed, self.dropout)
            x = self.Conv_1(x)
        x = self.BatchNorm_1(x, relu=True)
        return nchw_to_nhwc(torch.sigmoid(self.Conv_2(x)))


class SegmentationHead(nn.Module):
    """conv3×3 → BN → ReLU → dropout(0.1) → conv1×1.

    With ``upsample_scale`` the whole head runs fused over the ×scale
    upsample of the coarse input: ``seg_head_fused`` in eval mode (K2 on
    the card), ``seg_head_fused_train`` in train mode (K7/K8 on the card),
    plain versions on the CPU. Train mode needs the dropout ``seed``."""

    def __init__(self, cin: int, num_classes: int,
                 hidden_channels: int = 256, dropout: float = 0.1) -> None:
        super().__init__()
        self.Conv_0 = conv(cin, hidden_channels, 3)
        self.BatchNorm_0 = BatchNorm(hidden_channels)
        self.Conv_1 = conv(hidden_channels, num_classes, 1)
        self.dropout = dropout

    def forward(self, features: torch.Tensor,
                upsample_scale: int | None = None,
                seed: torch.Tensor | None = None) -> torch.Tensor:
        """features NHWC → logits NHWC; ``seed`` is an int32 tensor."""
        bn = self.BatchNorm_0
        if not self.training:
            if upsample_scale is not None:
                return seg_head_fused(features, hwio(self.Conv_0),
                                      self.Conv_0.bias, bn.weight, bn.bias,
                                      bn.running_mean, bn.running_var, bn.eps,
                                      hwio(self.Conv_1), self.Conv_1.bias,
                                      scale=upsample_scale)
            x = bn(self.Conv_0(nhwc_to_nchw(features)), relu=True)
            return nchw_to_nhwc(self.Conv_1(x))
        if seed is None:
            raise ValueError('SegmentationHead: train mode needs the dropout '
                             'seed')
        seed = rank_seed(seed, features.shape[0])
        if upsample_scale is not None and min(features.shape[1:3]) >= 2:
            y, mean, var = seg_head_fused_train(
                features, hwio(self.Conv_0), self.Conv_0.bias, bn.weight,
                bn.bias, bn.eps, hwio(self.Conv_1), self.Conv_1.bias,
                rate=self.dropout, seed=seed, scale=upsample_scale)
            bn.set_stats(mean, var)
            return y
        if upsample_scale is not None:
            x = nhwc_to_nchw(upsample_conv3x3(features, hwio(self.Conv_0),
                                              self.Conv_0.bias,
                                              scale=upsample_scale))
        else:
            x = self.Conv_0(nhwc_to_nchw(features))
        x = hash_dropout(F.relu(bn(x)), seed, self.dropout)
        return nchw_to_nhwc(self.Conv_1(x))
