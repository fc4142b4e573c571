"""Prediction heads of the plain reference: a frozen copy of
``awsegbench_torch/models/heads.py`` with every fused path taken out.

Each faithful head computes, by its definition, what the port's fused
kernels compute: the coarse features' ×scale bilinear upsample
(half-pixel, clamped: ``F.interpolate(align_corners=False)``), then the
first 3×3 conv at full resolution with zero padding, BN, ReLU, the
counter-hash dropout in train mode, and the rest of the head. BN is Flax's
in both modes (eps 1e-5, momentum 0.9, biased batch variance).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import dropout_keep_mask

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dims)
            sq = (xf * xf).mean(dims)
            var = torch.clamp(sq - mean * mean, min=0.0)
            self.set_stats(mean, var)
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
            return y.to(torch.result_type(x, self.weight))
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape))

    @torch.no_grad()
    def set_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold f32 batch statistics into the running ones (Flax's update)."""
        w = self.weight
        m, cdt = self.momentum, w.dtype
        # JAX casts the Python momentum to the stats' dtype before the
        # product (a weak-typed scalar); torch would multiply in f32
        m_c = torch.tensor(m, dtype=cdt, device=w.device)
        for buf, new in ((self.running_mean, mean), (self.running_var, var)):
            buf.copy_(buf.to(cdt) * m_c + (1.0 - m) * new.detach())


def hash_dropout(x: torch.Tensor, seed: torch.Tensor,
                 rate: float) -> torch.Tensor:
    """Dropout of an NCHW tensor by the counter-hash mask of ``seed`` over
    its NHWC positions (the port's kernels' mask)."""
    keep = dropout_keep_mask(nchw_to_nhwc(x).shape, seed, rate)
    return torch.where(nhwc_to_nchw(keep), x / (1.0 - rate), 0.0)


def upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC ``x`` bilinearly upsampled ×``scale``, as NCHW."""
    return F.interpolate(nhwc_to_nchw(x), scale_factor=scale,
                         mode='bilinear', align_corners=False)


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
    """conv3×3 → BN → ReLU → dropout(0.1) → conv3×3 → BN → ReLU → conv1×1 →
    sigmoid.

    With ``upsample_scale``, the input is the coarse field, upsampled
    ×scale before the first conv. Train mode needs the dropout ``seed``
    (the counter-hash mask)."""

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
        x = (nhwc_to_nchw(features) if upsample_scale is None
             else upsample(features, upsample_scale))
        x = self.Conv_0(x)
        x = F.relu(bn0(x))
        if self.training:
            x = hash_dropout(x, seed, self.dropout)
        x = self.Conv_1(x)
        x = F.relu(self.BatchNorm_1(x))
        return nchw_to_nhwc(torch.sigmoid(self.Conv_2(x)))


class SegmentationHead(nn.Module):
    """conv3×3 → BN → ReLU → dropout(0.1) → conv1×1.

    With ``upsample_scale`` the input is upsampled ×scale before the first
    conv. Train mode needs the dropout ``seed``."""

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
        if self.training and seed is None:
            raise ValueError('SegmentationHead: train mode needs the dropout '
                             'seed')
        x = (nhwc_to_nchw(features) if upsample_scale is None
             else upsample(features, upsample_scale))
        x = self.Conv_0(x)
        x = F.relu(bn(x))
        if self.training:
            x = hash_dropout(x, seed, self.dropout)
        return nchw_to_nhwc(self.Conv_1(x))
