"""Mask2Former-R50 for semantic segmentation in the plain reference
(arXiv:2112.01527; the Cityscapes semantic configuration
``maskformer2_R50_bs16_90k.yaml``), written from the published equations
and not from the port:

* the backbone is the reference's ResNet-50 (``models/deeplab.py``) at
  output stride 32;
* the pixel decoder projects res5, res4, res3 (1×1 conv, GroupNorm(32)),
  adds sine positions and a level embedding, and runs 6 post-norm layers
  of multi-scale deformable attention and a ReLU FFN over the three
  levels' tokens; the deformable sampling is written out: each location
  (x, y) read at pixel (x·W − 0.5, y·H − 0.5) from its four neighbours
  with the bilinear weights computed here, a neighbour outside the map
  reading zero; then the 1/4 output (lateral 1×1 conv + GN on res2, plus
  the 1/8 output upsampled ×2, a 3×3 conv + GN + ReLU) and the mask
  features;
* the decoder runs 100 queries through 9 post-norm layers of masked
  cross-attention (levels 1/32 → 1/16 → 1/8), self-attention and an FFN,
  a mask prediction before each layer whose resize to the next level gives
  the mask ``sigmoid < 0.5`` (a row masking every key unmasked);
  attention is ``matmul``, ``masked_fill`` and ``softmax``, so the fp8
  control (``reference/lowp.py``) reaches every product;
* semantic inference: ``einsum(softmax(cls)[..., :-1], sigmoid(masks
  upsampled))``.

All in f32. The module names and leaves are the port's, so one state dict
loads into both. ``sampling_offsets.bias`` takes the published grid on
load (a hook that ``builders/mask2former.py`` registers).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .deeplab import ResNetEncoder


def sampling_grid(n_heads: int, n_levels: int, n_points: int
                  ) -> torch.Tensor:
    """Deformable DETR's initial offsets: head h along (cos, sin)(2πh/M)
    over its larger coordinate, times point k + 1, the same every level;
    flat [M·L·P·2] f32."""
    out = torch.empty(n_heads, n_levels, n_points, 2)
    for h in range(n_heads):
        theta = 2.0 * math.pi * h / n_heads
        c, s = math.cos(theta), math.sin(theta)
        big = max(abs(c), abs(s))
        for k in range(n_points):
            out[h, :, k, 0] = c / big * (k + 1)
            out[h, :, k, 1] = s / big * (k + 1)
    return out.reshape(-1)


def sine_positions(h: int, w: int, feats: int, device) -> torch.Tensor:
    """Normalised sine positions of an h × w map, [h·w, 2·feats]: y's
    features then x's, sin on the even and cos on the odd ones."""
    y = (torch.arange(h, device=device, dtype=torch.float32) + 1) / (
        h + 1e-6) * 2 * math.pi
    x = (torch.arange(w, device=device, dtype=torch.float32) + 1) / (
        w + 1e-6) * 2 * math.pi
    i = torch.arange(feats, device=device, dtype=torch.float32)
    freq = 10000.0 ** (2 * torch.floor(i / 2) / feats)
    even = (torch.arange(feats, device=device) % 2) == 0

    def encode(t):
        a = t[:, None] / freq
        return torch.where(even, a.sin(), a.cos())
    py = encode(y)[:, None, :].expand(h, w, feats)
    px = encode(x)[None, :, :].expand(h, w, feats)
    return torch.cat([py, px], -1).reshape(h * w, 2 * feats)


def bilinear_samples(value: torch.Tensor, h: int, w: int,
                     loc: torch.Tensor) -> torch.Tensor:
    """value [B, M, h·w, D] at loc [B, M, N, 2] (x, y in [0, 1]) →
    [B, M, N, D]: four taps, zero outside the map (a location that is not
    finite reads zero)."""
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    out = 0.0
    for dy, dx, weight in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                           (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi, xi = y0 + dy, x0 + dx
        inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        idx = torch.where(inside, yi * w + xi, 0.0).long()
        tap = torch.gather(value, 2, idx[..., None].expand(
            *idx.shape, value.shape[-1]))
        out = out + tap * torch.where(inside, weight, 0.0)[..., None]
    return out


class ConvNorm(nn.Conv2d):
    """A bias-free conv, GroupNorm(32), optionally a ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 1,
                 relu: bool = False) -> None:
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = nn.GroupNorm(32, cout)
        self.relu = relu

    def forward(self, x):
        y = self.norm(F.conv2d(x, self.weight, None, 1, self.padding))
        return F.relu(y) if self.relu else y


class MSDeformAttn(nn.Module):
    def __init__(self, d: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4) -> None:
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = (n_levels, n_heads,
                                                      n_points)
        self.sampling_offsets = nn.Linear(d, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, ref, src, sizes):
        """query, src [B, N, d]; ref [N, 2] (x, y); sizes the levels'
        (h, w)."""
        b, n, d = query.shape
        m, lv, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(src).view(b, n, m, d // m).transpose(1, 2)
        off = self.sampling_offsets(query).view(b, n, m, lv, p, 2)
        weights = torch.softmax(self.attention_weights(query)
                                .view(b, n, m, lv * p), -1)
        samples, start = [], 0
        for lvl, (h, w) in enumerate(sizes):
            scale = torch.tensor([w, h], dtype=off.dtype, device=off.device)
            loc = ref[None, :, None, None, :] + off[:, :, :, lvl] / scale
            loc = loc.permute(0, 2, 1, 3, 4).reshape(b, m, n * p, 2)
            v = value[:, :, start:start + h * w]
            samples.append(bilinear_samples(v, h, w, loc)
                           .view(b, m, n, p, d // m))
            start += h * w
        samples = torch.cat(samples, 3)             # [B, M, N, L·P, D]
        out = torch.einsum('bmnk,bmnkd->bmnd',
                           weights.permute(0, 2, 1, 3), samples)
        return self.output_proj(out.transpose(1, 2).reshape(b, n, d))


class EncoderLayer(nn.Module):
    def __init__(self, d=256, ffn=1024, n_levels=3, n_heads=8, n_points=4):
        super().__init__()
        self.self_attn = MSDeformAttn(d, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d)
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, src, pos, ref, sizes):
        src = self.norm1(src + self.self_attn(src + pos, ref, src, sizes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DeformEncoder(nn.Module):
    def __init__(self, d, ffn, n_layers, n_levels, n_heads, n_points):
        super().__init__()
        self.level_embed = nn.Parameter(torch.zeros(n_levels, d))
        self.layers = nn.ModuleList(
            EncoderLayer(d, ffn, n_levels, n_heads, n_points)
            for _ in range(n_layers))

    def forward(self, src, sizes):
        dev, d = src.device, src.shape[-1]
        pos = torch.cat([sine_positions(h, w, d // 2, dev) + self.level_embed[i]
                         for i, (h, w) in enumerate(sizes)])
        refs = []
        for h, w in sizes:
            ry, rx = torch.meshgrid(
                (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h,
                (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w,
                indexing='ij')
            refs.append(torch.stack([rx.reshape(-1), ry.reshape(-1)], -1))
        ref = torch.cat(refs)
        for layer in self.layers:
            src = layer(src, pos, ref, sizes)
        return src


class MSDeformAttnPixelDecoder(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), conv_dim=256,
                 mask_dim=256, n_layers=6, n_heads=8, n_points=4, ffn=1024):
        super().__init__()
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, conv_dim, 1), nn.GroupNorm(32, conv_dim))
            for c in (in_channels[3], in_channels[2], in_channels[1]))
        self.transformer = DeformEncoder(conv_dim, ffn, n_layers, 3, n_heads,
                                         n_points)
        self.adapter_1 = ConvNorm(in_channels[0], conv_dim, 1)
        self.layer_1 = ConvNorm(conv_dim, conv_dim, 3, relu=True)
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 1)

    def forward(self, res2, res3, res4, res5):
        b = res2.shape[0]
        levels = (res5, res4, res3)
        sizes = [(f.shape[2], f.shape[3]) for f in levels]
        src = torch.cat([proj(f).flatten(2).transpose(1, 2)
                         for proj, f in zip(self.input_proj, levels)], 1)
        y = self.transformer(src, sizes)
        out, start = [], 0
        for h, w in sizes:
            out.append(y[:, start:start + h * w])
            start += h * w
        h8, w8 = sizes[2]
        fine = out[2].transpose(1, 2).reshape(b, -1, h8, w8)
        lateral = self.adapter_1(res2)
        up = F.interpolate(fine, size=lateral.shape[-2:], mode='bilinear',
                           align_corners=False)
        return self.mask_features(self.layer_1(lateral + up)), out, sizes


class Attention(nn.Module):
    """Multi-head attention written out: per-head ``matmul`` scores, the
    blocked keys filled with −inf, softmax, ``matmul`` with the values."""

    def __init__(self, d, n_heads):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, q, k, v, blocked=None):
        b, lq, d = q.shape
        h = self.n_heads
        w, bias = self.in_proj_weight, self.in_proj_bias

        def heads(x, i):
            return F.linear(x, w[i * d:(i + 1) * d],
                            bias[i * d:(i + 1) * d]).view(
                b, -1, h, d // h).transpose(1, 2)
        qh, kh, vh = heads(q, 0), heads(k, 1), heads(v, 2)
        scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(d // h)
        if blocked is not None:
            scores = scores.masked_fill(blocked[:, None], float('-inf'))
        out = torch.matmul(torch.softmax(scores, -1), vh)
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, d))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d, n_heads):
        super().__init__()
        self.multihead_attn = Attention(d, n_heads)
        self.norm = nn.LayerNorm(d)

    def forward(self, tgt, memory, blocked, pos, query_pos):
        return self.norm(tgt + self.multihead_attn(
            tgt + query_pos, memory + pos, memory, blocked))


class SelfAttentionLayer(nn.Module):
    def __init__(self, d, n_heads):
        super().__init__()
        self.self_attn = Attention(d, n_heads)
        self.norm = nn.LayerNorm(d)

    def forward(self, tgt, query_pos):
        return self.norm(tgt + self.self_attn(tgt + query_pos,
                                              tgt + query_pos, tgt))


class FFNLayer(nn.Module):
    def __init__(self, d, ffn):
        super().__init__()
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm = nn.LayerNorm(d)

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(F.relu(self.linear1(tgt))))


class MLP(nn.Module):
    def __init__(self, d, hidden, out, n_layers):
        super().__init__()
        dims = [d] + [hidden] * (n_layers - 1) + [out]
        self.layers = nn.ModuleList(nn.Linear(dims[i], dims[i + 1])
                                    for i in range(n_layers))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x


class MaskedTransformerDecoder(nn.Module):
    def __init__(self, num_classes, hidden_dim=256, num_queries=100,
                 n_heads=8, ffn=2048, n_layers=9, mask_dim=256):
        super().__init__()
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, n_heads) for _ in range(n_layers))
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(hidden_dim, n_heads) for _ in range(n_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hidden_dim, ffn) for _ in range(n_layers))
        self.decoder_norm = nn.LayerNorm(hidden_dim)
        self.query_feat = nn.Embedding(num_queries, hidden_dim)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.level_embed = nn.Embedding(3, hidden_dim)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)

    def heads(self, output, mask_features, size):
        """Mask logits and, for a level of ``size``, the blocked keys [B, Q,
        h·w] (every key of a row blocked: none)."""
        x = self.decoder_norm(output)
        masks = torch.einsum('bqc,bchw->bqhw', self.mask_embed(x),
                             mask_features)
        blocked = None
        if size is not None:
            small = F.interpolate(masks, size=size, mode='bilinear',
                                  align_corners=False)
            blocked = small.sigmoid().flatten(2) < 0.5
            blocked = blocked & ~blocked.all(-1, keepdim=True)
        return masks, blocked

    def forward(self, tokens, sizes, mask_features):
        b = mask_features.shape[0]
        d = tokens[0].shape[-1]
        src = [t + self.level_embed.weight[i] for i, t in enumerate(tokens)]
        pos = [sine_positions(h, w, d // 2, t.device)
               for t, (h, w) in zip(tokens, sizes)]
        output = self.query_feat.weight[None].repeat(b, 1, 1)
        query_pos = self.query_embed.weight
        n = len(self.transformer_ffn_layers)
        self.layer_masks = []
        masks, blocked = self.heads(output, mask_features, sizes[0])
        self.layer_masks.append(masks)
        for i in range(n):
            lvl = i % 3
            output = self.transformer_cross_attention_layers[i](
                output, src[lvl], blocked, pos[lvl], query_pos)
            output = self.transformer_self_attention_layers[i](output,
                                                               query_pos)
            output = self.transformer_ffn_layers[i](output)
            masks, blocked = self.heads(
                output, mask_features, sizes[(i + 1) % 3] if i < n - 1
                else None)
            self.layer_masks.append(masks)
        # the class logits of the last layer alone: the intermediate ones do
        # not reach the semantic output
        return self.class_embed(self.decoder_norm(output)), masks


class Mask2FormerModel(nn.Module):
    """NHWC images → ``{'segmentation': [B, H, W, classes]}``. After a
    forward, ``predictor.layer_masks`` holds every layer's mask logits."""

    def __init__(self, num_classes=19):
        super().__init__()
        self.backbone = ResNetEncoder(output_stride=32)
        self.pixel_decoder = MSDeformAttnPixelDecoder()
        self.predictor = MaskedTransformerDecoder(num_classes)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        feats = self.backbone(x.permute(0, 3, 1, 2))
        mask_features, tokens, sizes = self.pixel_decoder(*feats[2:6])
        cls, masks = self.predictor(tokens, sizes, mask_features)
        probs = torch.softmax(cls, -1)[..., :-1]
        up = F.interpolate(masks, size=(h, w), mode='bilinear',
                           align_corners=False).sigmoid()
        seg = torch.einsum('bqc,bqhw->bchw', probs, up)
        return {'segmentation': seg.permute(0, 2, 3, 1)}
