"""SegFormer: MiT encoder + faithful heads (counterpart of
``awsegbench/models/segformer.py``), eval mode.

Submodules carry the Flax scope names (``MiTEncoder_0.SegFormerBlock_3.
EfficientSelfAttention_0.Dense_0`` …) so the weight converter is
mechanical. Attention runs on ``[B·heads, N, head_dim]`` through
``ops.attention.sr_attention`` (the CUDA kernel on the card).

Parity notes:

* LayerNorm eps is 1e-6 everywhere (Flax ``nn.LayerNorm(epsilon=1e-6)``),
  not torch's 1e-5 default.
* Mix-FFN's GELU is the exact erf form (``approximate=False``), torch's
  default.
* The spatial-reduction conv uses Flax ``'SAME'`` padding (none when the
  map divides by the ratio, as on the main path).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sr_attention
from ..ops.resize import upsample_like
from .heads import DepthEstimationHead, SegmentationHead

LN_EPS = 1e-6

# MiT family (SegFormer paper table 7): (hidden_sizes, depths). All share
# heads (1,2,5,8), sr_ratios (8,4,2,1), mlp_ratios (4,4,4,4), patches
# 7/3/3/3 with strides 4/2/2/2.
MIT_VARIANTS: dict[str, tuple[tuple[int, ...], tuple[int, ...]]] = {
    'b0': ((32, 64, 160, 256), (2, 2, 2, 2)),
    'b1': ((64, 128, 320, 512), (2, 2, 2, 2)),
    'b2': ((64, 128, 320, 512), (3, 4, 6, 3)),
    'b3': ((64, 128, 320, 512), (3, 4, 18, 3)),
    'b4': ((64, 128, 320, 512), (3, 8, 27, 3)),
    'b5': ((64, 128, 320, 512), (3, 6, 40, 3)),
}


def mit_variant_config(name: str) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(hidden_sizes, depths) of MiT variant 'b0'..'b5'."""
    key = name.strip().lower()
    if key not in MIT_VARIANTS:
        raise ValueError(f'unknown MiT variant {name!r}; expected one of '
                         f'{sorted(MIT_VARIANTS)}')
    return MIT_VARIANTS[key]


def layer_norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, features: int, patch_size: int,
                 stride: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, patch_size, stride=stride,
                                padding=patch_size // 2)
        self.LayerNorm_0 = layer_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NHWC → NHWC
        y = self.Conv_0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.LayerNorm_0(y)


class EfficientSelfAttention(nn.Module):
    """Spatial-reduction attention: K/V come from the map downsampled by a
    strided ``sr_ratio`` conv, so scores are [N, N/sr²]."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int) -> None:
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.Dense_0 = nn.Linear(dim, dim)              # q
        if sr_ratio > 1:
            self.Conv_0 = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.LayerNorm_0 = layer_norm(dim)
        self.Dense_1 = nn.Linear(dim, dim)              # k
        self.Dense_2 = nn.Linear(dim, dim)              # v
        self.Dense_3 = nn.Linear(dim, dim)              # out proj

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        h, w = hw
        heads = self.num_heads
        hd = c // heads
        q = self.Dense_0(x)
        kv = x
        if self.sr_ratio > 1:
            s = self.sr_ratio
            xs = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
            py, px = _same_pad(h, s, s), _same_pad(w, s, s)
            xs = F.pad(xs, (px[0], px[1], py[0], py[1]))
            kv = self.LayerNorm_0(self.Conv_0(xs).flatten(2).transpose(1, 2))
        k, v = self.Dense_1(kv), self.Dense_2(kv)
        m = k.shape[1]

        def groups(t, length):  # [b, L, c] → [b·heads, L, hd]
            return t.reshape(b, length, heads, hd).transpose(1, 2).reshape(
                b * heads, length, hd)

        out = sr_attention(groups(q, n), groups(k, m), groups(v, m),
                           hd ** -0.5)
        out = out.reshape(b, heads, n, hd).transpose(1, 2).reshape(b, n, c)
        return self.Dense_3(out)


class MixFFN(nn.Module):
    """Dense → depthwise 3×3 → exact GELU → Dense."""

    def __init__(self, dim: int, mlp_ratio: int = 4) -> None:
        super().__init__()
        hidden = dim * mlp_ratio
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Conv_0 = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.Dense_1 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        b, n, _ = x.shape
        h, w = hw
        x = self.Dense_0(x)
        xs = self.Conv_0(x.reshape(b, h, w, -1).permute(0, 3, 1, 2))
        x = F.gelu(xs.flatten(2).transpose(1, 2), approximate='none')
        return self.Dense_1(x)


class SegFormerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: int = 4) -> None:
        super().__init__()
        self.LayerNorm_0 = layer_norm(dim)
        self.EfficientSelfAttention_0 = EfficientSelfAttention(
            dim, num_heads, sr_ratio)
        self.LayerNorm_1 = layer_norm(dim)
        self.MixFFN_0 = MixFFN(dim, mlp_ratio)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        x = x + self.EfficientSelfAttention_0(self.LayerNorm_0(x), hw)
        return x + self.MixFFN_0(self.LayerNorm_1(x), hw)


class MiTEncoder(nn.Module):
    """Mix Transformer encoder: [B, H, W, 3] → 4 NHWC stage features."""

    def __init__(self, hidden_sizes=(32, 64, 160, 256), depths=(2, 2, 2, 2),
                 num_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1),
                 patch_sizes=(7, 3, 3, 3), strides=(4, 2, 2, 2),
                 mlp_ratios=(4, 4, 4, 4)) -> None:
        super().__init__()
        self.depths = tuple(depths)
        cin, blk = 3, 0
        for i, c in enumerate(hidden_sizes):
            self.add_module(f'OverlapPatchEmbed_{i}', OverlapPatchEmbed(
                cin, c, patch_sizes[i], strides[i]))
            for _ in range(depths[i]):
                self.add_module(f'SegFormerBlock_{blk}', SegFormerBlock(
                    c, num_heads[i], sr_ratios[i], mlp_ratios[i]))
                blk += 1
            self.add_module(f'LayerNorm_{i}', layer_norm(c))
            cin = c

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        features, blk = [], 0
        for i, depth in enumerate(self.depths):
            x = getattr(self, f'OverlapPatchEmbed_{i}')(x)
            b, h, w, c = x.shape
            tokens = x.reshape(b, h * w, c)
            for _ in range(depth):
                tokens = getattr(self, f'SegFormerBlock_{blk}')(tokens, (h, w))
                blk += 1
            x = getattr(self, f'LayerNorm_{i}')(tokens).reshape(b, h, w, c)
            features.append(x)
        return features


class SegFormerModel(nn.Module):
    """SegFormer with seg + optional depth head; NHWC in and out."""

    def __init__(self, num_classes: int = 19, include_depth: bool = True,
                 head_mode: str = 'faithful',
                 hidden_sizes=(32, 64, 160, 256), depths=(2, 2, 2, 2)) -> None:
        super().__init__()
        if head_mode not in ('faithful', 'fused'):
            raise ValueError(f'unknown head_mode {head_mode!r}')
        self.include_depth = include_depth
        self.head_mode = head_mode
        self.MiTEncoder_0 = MiTEncoder(hidden_sizes=hidden_sizes,
                                       depths=depths)
        c = hidden_sizes[-1]
        self.SegmentationHead_0 = SegmentationHead(c, num_classes)
        if include_depth:
            self.DepthEstimationHead_0 = DepthEstimationHead(
                c, hidden_channels=128)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        h, w = x.shape[1], x.shape[2]
        feat = self.MiTEncoder_0(x)[-1]
        if self.head_mode == 'faithful':
            # The heads see the features upsampled to the input size. For an
            # integer ×scale (the encoder downsamples by exactly 32) the
            # upsample fuses into each head's first conv; otherwise it is
            # materialized.
            fh, fw = feat.shape[1], feat.shape[2]
            scale = h // fh if fh else 0
            up = (scale if scale >= 4 and h == fh * scale and w == fw * scale
                  else None)
            if up is None:
                feat = upsample_like(feat, (h, w))
            out = {'segmentation': self.SegmentationHead_0(feat, up)}
            if self.include_depth:
                out['depth'] = self.DepthEstimationHead_0(feat, up)
            return out
        out = {'segmentation': upsample_like(self.SegmentationHead_0(feat),
                                             (h, w))}
        if self.include_depth:
            out['depth'] = upsample_like(self.DepthEstimationHead_0(feat),
                                         (h, w))
        return out
