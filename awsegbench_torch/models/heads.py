"""Prediction heads, eval mode (counterpart of ``awsegbench/models/heads.py``).

Submodules are named after the Flax scopes (``Conv_0``, ``BatchNorm_0``, …)
so ``convert.flax_to_torch`` maps a Flax variable tree onto them name for
name. Public tensors are NHWC like the JAX package; the library convs run
on NCHW views.

Parity notes:

* BN is eval mode with running statistics and eps 1e-5, computed as Flax
  does: ``(x − mean)·(rsqrt(var + eps)·scale) + bias`` in the promoted
  dtype of x and the parameters. Its buffers are ``running_mean`` and
  ``running_var``; there is no ``num_batches_tracked``.
* Padding is torch-style symmetric, ``d·(k−1)/2`` per side, for every
  ``ConvBNReLU`` (``heads.py:176-186`` in the JAX package pads that way on
  purpose: Flax ``'SAME'`` at stride 2 pads (0, 1) on even inputs). Stride-1
  ``'SAME'`` convs are the same symmetric padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.headkernels import seg_head_fused
from ..ops.upconv import upsample_conv3x3

BN_EPS = 1e-5


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A Conv2d weight in the JAX (kH, kW, Cin, Cout) layout."""
    return conv.weight.permute(2, 3, 1, 0)


class BatchNorm(nn.Module):
    """Eval-mode batch norm over channel dim 1 (NCHW), Flax formula."""

    def __init__(self, c: int, eps: float = BN_EPS) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape))


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
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.use_relu else x


class DepthEstimationHead(nn.Module):
    """conv3×3 → BN → ReLU → conv3×3 → BN → ReLU → conv1×1 → sigmoid.

    With ``upsample_scale``, the input is the coarse field and the first
    conv is fused with the ×scale bilinear upsample (``upsample_conv3x3``);
    the rest are library convs at full resolution."""

    def __init__(self, cin: int, hidden_channels: int = 256,
                 out_channels: int = 1) -> None:
        super().__init__()
        c1, c2 = hidden_channels, hidden_channels // 2
        self.Conv_0 = conv(cin, c1, 3)
        self.BatchNorm_0 = BatchNorm(c1)
        self.Conv_1 = conv(c1, c2, 3)
        self.BatchNorm_1 = BatchNorm(c2)
        self.Conv_2 = conv(c2, out_channels, 1)

    def forward(self, features: torch.Tensor,
                upsample_scale: int | None = None) -> torch.Tensor:
        """features NHWC → depth NHWC [B, H', W', 1]."""
        if upsample_scale is not None:
            x = nhwc_to_nchw(upsample_conv3x3(features, hwio(self.Conv_0),
                                              self.Conv_0.bias,
                                              scale=upsample_scale))
        else:
            x = self.Conv_0(nhwc_to_nchw(features))
        x = F.relu(self.BatchNorm_0(x))
        x = F.relu(self.BatchNorm_1(self.Conv_1(x)))
        return nchw_to_nhwc(torch.sigmoid(self.Conv_2(x)))


class SegmentationHead(nn.Module):
    """conv3×3 → BN → ReLU → (dropout: identity in eval) → conv1×1.

    With ``upsample_scale`` the whole head runs fused over the ×scale
    upsample of the coarse input (``seg_head_fused``: the CUDA kernel on the
    card, its plain version on the CPU)."""

    def __init__(self, cin: int, num_classes: int,
                 hidden_channels: int = 256) -> None:
        super().__init__()
        self.Conv_0 = conv(cin, hidden_channels, 3)
        self.BatchNorm_0 = BatchNorm(hidden_channels)
        self.Conv_1 = conv(hidden_channels, num_classes, 1)

    def forward(self, features: torch.Tensor,
                upsample_scale: int | None = None) -> torch.Tensor:
        """features NHWC → logits NHWC."""
        if upsample_scale is not None:
            bn = self.BatchNorm_0
            return seg_head_fused(features, hwio(self.Conv_0),
                                  self.Conv_0.bias, bn.weight, bn.bias,
                                  bn.running_mean, bn.running_var, bn.eps,
                                  hwio(self.Conv_1), self.Conv_1.bias,
                                  scale=upsample_scale)
        x = F.relu(self.BatchNorm_0(self.Conv_0(nhwc_to_nchw(features))))
        return nchw_to_nhwc(self.Conv_1(x))
