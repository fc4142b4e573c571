"""The Swin Transformer backbone (no counterpart in the JAX package), as
Mask2Former's ``D2SwinTransformer`` builds it (Liu et al., arXiv:2103.14030;
Mask2Former's ``modeling/backbone/swin.py``):

* a 4×4 stride-4 patch embedding and its LayerNorm;
* four stages of pre-norm blocks, ``x + attn(norm1(x))`` then ``x +
  fc2(GELU(fc1(norm2(x))))`` (exact GELU, LayerNorm eps 1e-5); each block
  pads its normed map with zeros to multiples of the window after
  ``norm1`` (the padded tokens are not masked: they take part as keys and
  values, carrying the qkv bias), odd blocks roll it by (−w/2, −w/2);
  the window attention is K15 (``ops/window_attention.py``), which folds
  the roll, the window partition, its reverse and the roll back into its
  index arithmetic; the qkv projection is per token and runs on the padded
  map in map order;
* patch merging between stages: the 2×2 gather ``x[0::2, 0::2],
  x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]`` (an odd side padded),
  LayerNorm(4C) and a bias-free Linear(4C, 2C);
* an output LayerNorm ``norm{i}`` on each stage's output, res2…res5.

NCHW images in, res2…res5 out as NCHW views of NHWC maps. Module and leaf
names are the published checkpoint's; the relative position index and the
shift masks are computed, not held in the state dict (the published
checkpoint's ``relative_position_index`` buffers and a shift-mask table,
if any, are not loaded). No drop path: the backbone runs in eval.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.window_attention import window_attention

LN_EPS = 1e-5


class PatchEmbed(nn.Module):
    """4×4 stride-4 conv (the input padded to multiples of 4) and a
    LayerNorm; NCHW in, NHWC out."""

    def __init__(self, dim: int, patch: int = 4) -> None:
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        if h % self.patch or w % self.patch:
            x = F.pad(x, (0, -w % self.patch, 0, -h % self.patch))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class WindowAttention(nn.Module):
    """qkv, K15 and the output projection on a map padded to windows."""

    def __init__(self, dim: int, heads: int, window: int) -> None:
        super().__init__()
        self.heads, self.window = heads, window
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """x [B, Hp, Wp, C], Hp and Wp multiples of the window."""
        return self.proj(window_attention(
            self.qkv(x), self.relative_position_bias_table, self.heads,
            self.window, shift, self.scale))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate='none'))


class SwinBlock(nn.Module):
    """One pre-norm block; ``shift`` 0 (plain windows) or window // 2."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float) -> None:
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # NHWC
        h, w = x.shape[1], x.shape[2]
        y = self.norm1(x)
        ph, pw = -h % self.window, -w % self.window
        if ph or pw:
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
        x = x + self.attn(y, self.shift)[:, :h, :w]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """The 2×2 gather (an odd side padded), LayerNorm(4C), Linear(4C, 2C)
    without bias; NHWC in and out."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    """A stage's blocks (the odd ones shifted) and the merging after it."""

    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 mlp_ratio: float, downsample: bool) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if i % 2 == 0 else window // 2,
                      mlp_ratio) for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class SwinTransformer(nn.Module):
    """NCHW images → [res2, res3, res4, res5] (NCHW views), each after its
    output LayerNorm; ``channels`` their widths."""

    def __init__(self, embed_dim: int, depths, num_heads,
                 window_size: int = 12, mlp_ratio: float = 4) -> None:
        super().__init__()
        n = len(depths)
        self.channels = tuple(embed_dim * 2 ** i for i in range(n))
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            SwinStage(c, d, h, window_size, mlp_ratio, i < n - 1)
            for i, (c, d, h) in enumerate(zip(self.channels, depths,
                                              num_heads)))
        for i, c in enumerate(self.channels):
            setattr(self, f'norm{i}', nn.LayerNorm(c, eps=LN_EPS))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.layers):
            x = stage(x)
            outs.append(getattr(self, f'norm{i}')(x).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """The part of the port's init (``factory.init_model``) that its
    generic rules do not cover: each relative position bias table
    truncated-normal 0.02, as published."""
    for mod in model.modules():
        if isinstance(mod, WindowAttention):
            nn.init.trunc_normal_(mod.relative_position_bias_table, std=0.02,
                                  a=-0.04, b=0.04, generator=generator)
