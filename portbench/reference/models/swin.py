"""The Swin Transformer backbone in the plain reference (arXiv:2103.14030),
as Mask2Former's ``D2SwinTransformer`` (``modeling/backbone/swin.py``)
writes it, and not from the port: tokens [B, L, C]; in each block
``norm1``, then the map padded with zeros to multiples of the window
(the padded tokens unmasked: they take part as keys and values), a
``torch.roll`` by (−w/2, −w/2) in the odd blocks, ``window_partition``,
the window attention (``q·scale @ kᵀ``, the bias gathered from the table
by ``relative_position_index``, the ``img_mask`` slices' −100 mask added,
softmax, ``@ v``), ``window_reverse``, the roll back and the crop; then
the MLP with the exact GELU. Patch merging gathers x0…x3, pads an odd
side, LayerNorm(4C), Linear(4C, 2C) without bias; res2…res5 are the
stages' outputs through ``norm0``…``norm3``, NCHW.

All in f32. Departure: the relative position index and the shift mask
are computed in the forward, not held as buffers (the state dict holds
the parameters alone, as the port's)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def window_partition(x, window_size):
    b, h, w, c = x.shape
    x = x.view(b, h // window_size, window_size, w // window_size,
               window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(
        -1, window_size, window_size, c)


def window_reverse(windows, window_size, h, w):
    b = int(windows.shape[0] / (h * w / window_size / window_size))
    x = windows.view(b, h // window_size, w // window_size, window_size,
                     window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index(window_size, device):
    coords = torch.stack(torch.meshgrid(
        torch.arange(window_size, device=device),
        torch.arange(window_size, device=device), indexing='ij'))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window_size - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 0] *= 2 * window_size - 1
    return rel.sum(-1)


def shift_attn_mask(hp, wp, window_size, shift_size, device):
    img_mask = torch.zeros((1, hp, wp, 1), device=device)
    slices = (slice(0, -window_size), slice(-window_size, -shift_size),
              slice(-shift_size, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, window_size).view(
        -1, window_size * window_size)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(
        attn_mask == 0, float(0.0))


class WindowAttention(nn.Module):
    def __init__(self, dim, window_size, num_heads):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        b_, n, c = x.shape
        qkv = self.qkv(x).reshape(b_, n, 3, self.num_heads,
                                  c // self.num_heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        index = relative_position_index(self.window_size, x.device)
        bias = self.relative_position_bias_table[index.view(-1)].view(
            n, n, -1).permute(2, 0, 1).contiguous()
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, self.num_heads, n, n) \
                + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, n, n)
        attn = torch.softmax(attn, -1)
        x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, h, w, mask_matrix):
        b, _, c = x.shape
        ws = self.window_size
        shortcut = x
        x = self.norm1(x).view(b, h, w, c)
        pad_r, pad_b = (ws - w % ws) % ws, (ws - h % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        _, hp, wp, _ = x.shape
        if self.shift_size > 0:
            shifted = torch.roll(x, shifts=(-self.shift_size,
                                            -self.shift_size), dims=(1, 2))
            attn_mask = mask_matrix
        else:
            shifted, attn_mask = x, None
        windows = window_partition(shifted, ws).view(-1, ws * ws, c)
        windows = self.attn(windows, mask=attn_mask).view(-1, ws, ws, c)
        shifted = window_reverse(windows, ws, hp, wp)
        if self.shift_size > 0:
            x = torch.roll(shifted, shifts=(self.shift_size,
                                            self.shift_size), dims=(1, 2))
        else:
            x = shifted
        x = x[:, :h, :w, :].contiguous().view(b, h * w, c)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x, h, w):
        b, _, c = x.shape
        x = x.view(b, h, w, c)
        if h % 2 == 1 or w % 2 == 1:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x0, x1 = x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :]
        x2, x3 = x[:, 0::2, 1::2, :], x[:, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3], -1).view(b, -1, 4 * c)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio,
                 downsample):
        super().__init__()
        self.window_size, self.shift_size = window_size, window_size // 2
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, window_size,
                                 0 if i % 2 == 0 else window_size // 2,
                                 mlp_ratio) for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, h, w):
        ws = self.window_size
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        attn_mask = shift_attn_mask(hp, wp, ws, self.shift_size, x.device)
        for blk in self.blocks:
            x = blk(x, h, w, attn_mask)
        if self.downsample is not None:
            return x, h, w, self.downsample(x, h, w), (h + 1) // 2, \
                (w + 1) // 2
        return x, h, w, x, h, w


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, embed_dim):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x):
        _, _, h, w = x.size()
        p = self.patch_size
        if w % p != 0:
            x = F.pad(x, (0, p - w % p))
        if h % p != 0:
            x = F.pad(x, (0, 0, 0, p - h % p))
        x = self.proj(x)
        wh, ww = x.size(2), x.size(3)
        x = self.norm(x.flatten(2).transpose(1, 2))
        return x.transpose(1, 2).view(-1, x.shape[-1], wh, ww)


class SwinTransformer(nn.Module):
    """NCHW images → [res2, res3, res4, res5] NCHW."""

    def __init__(self, embed_dim, depths, num_heads, window_size=12,
                 mlp_ratio=4.0):
        super().__init__()
        n = len(depths)
        self.num_features = [int(embed_dim * 2 ** i) for i in range(n)]
        self.patch_embed = PatchEmbed(4, embed_dim)
        self.layers = nn.ModuleList(
            BasicLayer(self.num_features[i], depths[i], num_heads[i],
                       window_size, mlp_ratio, i < n - 1) for i in range(n))
        for i in range(n):
            self.add_module(f'norm{i}', nn.LayerNorm(self.num_features[i]))

    def forward(self, x):
        x = self.patch_embed(x)
        wh, ww = x.size(2), x.size(3)
        x = x.flatten(2).transpose(1, 2)
        outs = []
        for i, layer in enumerate(self.layers):
            x_out, h, w, x, wh, ww = layer(x, wh, ww)
            x_out = getattr(self, f'norm{i}')(x_out)
            outs.append(x_out.view(-1, h, w, self.num_features[i])
                        .permute(0, 3, 1, 2).contiguous())
        return outs
