"""DeepLabV3+ with a ResNet-50 encoder (counterpart of
``awsegbench/models/deeplab.py``), eval mode.

ResNet-50 at output stride 16 (layer4 dilated; 8 and 32 also built), ASPP
with separable atrous convs at rates 12/24/36 plus image pooling, a ×4
decoder with a 48-channel low-level projection, a 1×1 classifier, and a
depth head at output stride 16 upsampled to the input. All convs are
library (cuDNN) convs, as they were XLA convs in the JAX package.

Parity notes: every conv pads symmetrically, ``d·(k−1)/2`` per side (the
stride-2 3×3 convs of layer2/layer3 included, see ``heads.py``); the stem's
max-pool pads with −inf (``F.max_pool2d`` and Flax ``nn.max_pool`` agree);
the 1×1 stride-2 shortcut convs pad nothing. Submodule names follow the
Flax scopes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import upsample_like
from .heads import (BatchNorm, ConvBNReLU, DepthEstimationHead, conv,
                    nchw_to_nhwc, nhwc_to_nchw)


class Bottleneck(nn.Module):
    """1×1 reduce → 3×3 → 1×1 expand (×4) + residual."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False) -> None:
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(cin, features, 1)
        self.ConvBNReLU_1 = ConvBNReLU(features, features, 3, stride, dilation)
        self.Conv_0 = conv(features, features * 4, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(features * 4)
        self.downsample = downsample
        if downsample:
            self.Conv_1 = nn.Conv2d(cin, features * 4, 1, stride=stride,
                                    bias=False)
            self.BatchNorm_1 = BatchNorm(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:    # NCHW
        y = self.BatchNorm_0(self.Conv_0(self.ConvBNReLU_1(
            self.ConvBNReLU_0(x))))
        residual = self.BatchNorm_1(self.Conv_1(x)) if self.downsample else x
        return F.relu(y + residual)


_STRIDES = {16: ((1, 2, 2, 1), (1, 1, 1, 2)),
            8: ((1, 2, 1, 1), (1, 1, 2, 4)),
            32: ((1, 2, 2, 2), (1, 1, 1, 1))}


class ResNetEncoder(nn.Module):
    """ResNet stem + 4 stages; returns [x, stem, layer1..layer4] (NCHW)."""

    def __init__(self, layers=(3, 4, 6, 3), widths=(64, 128, 256, 512),
                 output_stride: int = 16) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.BatchNorm_0 = BatchNorm(64)
        strides, dilations = _STRIDES[output_stride]
        self.stages: list[int] = []
        cin, blk = 64, 0
        for stage, (n_blocks, width) in enumerate(zip(layers, widths)):
            for i in range(n_blocks):
                self.add_module(f'Bottleneck_{blk}', Bottleneck(
                    cin, width, strides[stage] if i == 0 else 1,
                    dilations[stage], downsample=(i == 0)))
                cin = width * 4
                blk += 1
            self.stages.append(n_blocks)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = [x]
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        feats.append(y)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        blk = 0
        for n_blocks in self.stages:
            for _ in range(n_blocks):
                y = getattr(self, f'Bottleneck_{blk}')(y)
                blk += 1
            feats.append(y)
        return feats


class SeparableConvBNReLU(nn.Module):
    """Depthwise 3×3 (dilated) + pointwise 1×1 + BN + ReLU."""

    def __init__(self, cin: int, features: int, dilation: int = 1) -> None:
        super().__init__()
        self.Conv_0 = conv(cin, cin, 3, dilation=dilation, groups=cin,
                           bias=False)
        self.Conv_1 = conv(cin, features, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_1(self.Conv_0(x))))


class ASPP(nn.Module):
    """1×1 branch, three separable atrous branches, image pooling, 1×1
    projection (dropout is the identity in eval)."""

    def __init__(self, cin: int, features: int = 256,
                 atrous_rates=(12, 24, 36)) -> None:
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(cin, features, 1)
        for i, rate in enumerate(atrous_rates):
            self.add_module(f'SeparableConvBNReLU_{i}',
                            SeparableConvBNReLU(cin, features, rate))
        self.n_rates = len(atrous_rates)
        self.ConvBNReLU_1 = ConvBNReLU(cin, features, 1)          # pooling
        self.ConvBNReLU_2 = ConvBNReLU(features * (self.n_rates + 2),
                                       features, 1)               # project

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.ConvBNReLU_0(x)]
        branches += [getattr(self, f'SeparableConvBNReLU_{i}')(x)
                     for i in range(self.n_rates)]
        pooled = self.ConvBNReLU_1(x.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return self.ConvBNReLU_2(torch.cat(branches, dim=1))


class DeepLabV3PlusModel(nn.Module):
    """DeepLabV3+ with seg + optional depth head; NHWC in and out."""

    def __init__(self, num_classes: int = 19, include_depth: bool = True,
                 output_stride: int = 16, decoder_channels: int = 256,
                 encoder_layers=(3, 4, 6, 3),
                 encoder_widths=(64, 128, 256, 512)) -> None:
        super().__init__()
        self.include_depth = include_depth
        high_c, low_c = encoder_widths[3] * 4, encoder_widths[0] * 4
        dc = decoder_channels
        self.ResNetEncoder_0 = ResNetEncoder(encoder_layers, encoder_widths,
                                             output_stride)
        self.ASPP_0 = ASPP(high_c, dc)
        self.SeparableConvBNReLU_0 = SeparableConvBNReLU(dc, dc)
        self.ConvBNReLU_0 = ConvBNReLU(low_c, 48, 1)
        self.SeparableConvBNReLU_1 = SeparableConvBNReLU(dc + 48, dc)
        self.Conv_0 = nn.Conv2d(dc, num_classes, 1)
        if include_depth:
            self.DepthEstimationHead_0 = DepthEstimationHead(
                high_c, hidden_channels=256)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        h, w = x.shape[1], x.shape[2]
        feats = self.ResNetEncoder_0(nhwc_to_nchw(x))
        high, low = feats[-1], feats[2]          # os16 2048 ch, os4 256 ch
        y = self.SeparableConvBNReLU_0(self.ASPP_0(high))
        y = nhwc_to_nchw(upsample_like(nchw_to_nhwc(y), low.shape[2:]))
        y = torch.cat([y, self.ConvBNReLU_0(low)], dim=1)
        y = self.Conv_0(self.SeparableConvBNReLU_1(y))
        out = {'segmentation': upsample_like(nchw_to_nhwc(y), (h, w))}
        if self.include_depth:
            # encoder features shared with the seg path (the reference
            # re-runs the encoder; same numbers)
            depth = self.DepthEstimationHead_0(nchw_to_nhwc(high))
            out['depth'] = upsample_like(depth, (h, w))
        return out
