"""Mask2Former with a ResNet-50 or a Swin backbone, semantic inference (no
counterpart in the JAX package).

Cheng et al., "Masked-attention Mask Transformer for Universal Image
Segmentation" (arXiv:2112.01527), as its Cityscapes semantic configurations
(``maskformer2_R50_bs16_90k.yaml``, and
``swin/maskformer2_swin_large_IN21k_384_bs16_90k.yaml`` on the same base)
build it:

* backbone: ``deeplab.ResNetEncoder`` at output stride 32 (res2…res5 at
  1/4…1/32), or ``swin.SwinTransformer`` (:func:`mask2former_swin`; Swin-L
  by default), whose widths the pixel decoder's inputs take;
* pixel decoder (``MSDeformAttnPixelDecoder``): res5, res4, res3 each
  through a 1×1 conv and GroupNorm(32); sine positions (128 features a
  axis, normalised) plus a learned level embedding; 6 post-norm encoder
  layers of multi-scale deformable attention (8 heads, 3 levels, 4
  points; K11, ``ops/ms_deform_attn.py``) and a ReLU FFN of 1024 over the
  three levels' tokens together, the reference points at pixel centres;
  then the 1/4 output, a lateral 1×1 conv + GN on res2 plus a bilinear ×2
  of the 1/8 output, through a 3×3 conv + GN + ReLU, and ``mask_features``,
  a 1×1 conv;
* transformer decoder (``MultiScaleMaskedTransformerDecoder``): 100
  queries of 256, 9 post-norm layers of masked cross-attention (the levels
  round robin, 1/32 → 1/16 → 1/8), self-attention and an FFN of 2048; before
  each layer a mask prediction (``decoder_norm``, the 3-layer mask MLP, its
  product with ``mask_features``) whose bilinear resize to the next level
  gives the attention mask ``sigmoid(logit) < 0.5``, computed as ``logit <
  0`` (the same set); a query whose mask blocks every key is unblocked;
* semantic inference: the last masks upsampled bilinearly to the input,
  ``einsum('bqc,bqhw->bchw', softmax(cls)[..., :-1], sigmoid(masks))``.

The class head runs once, on the last layer's output: the intermediate
class predictions (the published model's auxiliary outputs) do not reach
the semantic output. Every mask prediction that feeds an attention mask
is computed; the last one feeds the semantic inference alone.

Precision: the sampling locations and the deformable attention weights
are f32 (a bf16 location on a 256-wide map is off by up to a pixel); the
rest runs in the parameters' dtype. The masked cross-attention is
``F.scaled_dot_product_attention`` with one boolean mask broadcast over
the heads.

NHWC images in, ``{'segmentation': [B, H, W, num_classes]}`` out. The
module names of the pixel decoder and the decoder are the published
checkpoint's (under ``sem_seg_head.``); the ResNet keeps the port's
``ResNetEncoder`` names, the Swin the published ones.
``factory.init_model`` gives ``sampling_offsets`` the published grid
(Deformable DETR's ``_reset_parameters``); the module
registers no load hook, so a checkpoint holding the grid is loaded as it
is. Spatial tiling cannot split it (``tileable``): its attention is
global.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import const
from ..ops.ms_deform_attn import ms_deform_attn
from .deeplab import ResNetEncoder
from .heads import nhwc_to_nchw
from .swin import SwinTransformer

LEVELS = 3            # res5, res4, res3: the encoder's and the decoder's levels


def sampling_grid(n_heads: int, n_levels: int, n_points: int
                  ) -> torch.Tensor:
    """Deformable DETR's initial ``sampling_offsets.bias`` (f32, flat):
    head h points along (cos, sin)(2πh / n_heads), scaled so that the
    larger coordinate is 1, times point k + 1, the same at every level."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (
        2.0 * math.pi / n_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = (grid / grid.abs().max(-1, keepdim=True)[0]).view(
        n_heads, 1, 1, 2).repeat(1, n_levels, n_points, 1)
    for k in range(n_points):
        grid[:, :, k, :] *= k + 1
    return grid.reshape(-1)


def sine_positions(h: int, w: int, feats: int) -> torch.Tensor:
    """``PositionEmbeddingSine(feats, normalize=True)`` of an h × w map as
    tokens [h·w, 2·feats] (y's features, then x's), f32."""
    ones = torch.ones(1, h, w)
    y = ones.cumsum(1) / (h + 1e-6) * (2 * math.pi)
    x = ones.cumsum(2) / (w + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(feats, dtype=torch.float32)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode='floor')
                        / feats)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()),
                     dim=4).flatten(3)
    py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()),
                     dim=4).flatten(3)
    return torch.cat((py, px), dim=3).reshape(h * w, 2 * feats)


def reference_points(sizes: tuple[tuple[int, int], ...]) -> torch.Tensor:
    """The encoder's reference points, every level's pixel centres
    ((j + 0.5) / W, (i + 0.5) / H), as [Σ h·w, 2] f32 (x, y)."""
    out = []
    for h, w in sizes:
        ry, rx = torch.meshgrid(
            torch.linspace(0.5, h - 0.5, h, dtype=torch.float32),
            torch.linspace(0.5, w - 0.5, w, dtype=torch.float32),
            indexing='ij')
        out.append(torch.stack((rx.reshape(-1) / w, ry.reshape(-1) / h), -1))
    return torch.cat(out)


def _normalizer(sizes: tuple[tuple[int, int], ...]) -> torch.Tensor:
    """Each level's (W, H), [L, 2] f32."""
    return torch.tensor([[w, h] for h, w in sizes], dtype=torch.float32)


class ConvNorm(nn.Conv2d):
    """A conv followed by GroupNorm(32) (detectron2's ``Conv2d(norm=GN)``),
    optionally a ReLU."""

    def __init__(self, cin: int, cout: int, k: int = 1,
                 relu: bool = False) -> None:
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = nn.GroupNorm(32, cout)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(super().forward(x))
        return F.relu(y) if self.relu else y


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (Deformable DETR): each query's
    heads sample ``n_points`` locations a level around its reference point
    and sum them by softmaxed weights."""

    def __init__(self, d_model: int = 256, n_heads: int = 8,
                 n_points: int = 4) -> None:
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = LEVELS, n_heads, n_points
        n = n_heads * LEVELS * n_points
        self.sampling_offsets = nn.Linear(d_model, 2 * n)
        self.attention_weights = nn.Linear(d_model, n)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def grid(self) -> torch.Tensor:
        return sampling_grid(self.n_heads, self.n_levels, self.n_points)

    def forward(self, query: torch.Tensor, ref: torch.Tensor,
                src: torch.Tensor, sizes: tuple[tuple[int, int], ...]
                ) -> torch.Tensor:
        """query, src [B, N, d] (the levels' tokens), ref [N, 2] f32."""
        b, n, d = query.shape
        m, lv, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(src).view(b, n, m, d // m)
        off = self.sampling_offsets(query).view(b, n, m, lv, p, 2).float()
        w = F.softmax(self.attention_weights(query).view(b, n, m, lv * p)
                      .float(), -1).view(b, n, m, lv, p)
        norm = const(_normalizer, sizes, device=query.device)
        loc = torch.addcdiv(ref.view(1, n, 1, 1, 1, 2), off,
                            norm.view(1, 1, 1, lv, 1, 2))
        out = ms_deform_attn(value, [x for hw in sizes for x in hw], loc, w)
        return self.output_proj(out)


class EncoderLayer(nn.Module):
    """Deformable self-attention and a ReLU FFN, each post-norm."""

    def __init__(self, d: int = 256, ffn: int = 1024, n_heads: int = 8,
                 n_points: int = 4) -> None:
        super().__init__()
        self.self_attn = MSDeformAttn(d, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d)
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, src, pos, ref, sizes):
        src = self.norm1(src + self.self_attn(src + pos, ref, src, sizes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DeformEncoder(nn.Module):
    """The pixel decoder's transformer: the level embedding and the
    layers."""

    def __init__(self, d: int, ffn: int, n_layers: int, n_heads: int,
                 n_points: int) -> None:
        super().__init__()
        self.level_embed = nn.Parameter(torch.zeros(LEVELS, d))
        self.layers = nn.ModuleList(
            EncoderLayer(d, ffn, n_heads, n_points) for _ in range(n_layers))

    def forward(self, src: torch.Tensor, sizes) -> torch.Tensor:
        dev, d = src.device, src.shape[-1]
        pos = torch.cat([
            const(sine_positions, h, w, d // 2, device=dev).to(src.dtype)
            + self.level_embed[i] for i, (h, w) in enumerate(sizes)])
        ref = const(reference_points, sizes, device=dev)
        for layer in self.layers:
            src = layer(src, pos, ref, sizes)
        return src


class MSDeformAttnPixelDecoder(nn.Module):
    """res2…res5 (NCHW) → (``mask_features`` [B, mask_dim, H/4, W/4], the
    encoder's 1/32, 1/16, 1/8 levels as tokens with their sizes)."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), conv_dim: int = 256,
                 mask_dim: int = 256, n_layers: int = 6, n_heads: int = 8,
                 n_points: int = 4, ffn: int = 1024) -> None:
        super().__init__()
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, conv_dim, 1),
                          nn.GroupNorm(32, conv_dim))
            for c in in_channels[:0:-1])               # res5, res4, res3
        self.transformer = DeformEncoder(conv_dim, ffn, n_layers, n_heads,
                                         n_points)
        self.adapter_1 = ConvNorm(in_channels[0], conv_dim, 1)
        self.layer_1 = ConvNorm(conv_dim, conv_dim, 3, relu=True)
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 1)

    def forward(self, res: list[torch.Tensor]):
        b = res[0].shape[0]
        levels = res[:0:-1]                            # res5, res4, res3
        sizes = tuple((int(f.shape[2]), int(f.shape[3])) for f in levels)
        src = torch.cat([proj(f).flatten(2).transpose(1, 2)
                         for proj, f in zip(self.input_proj, levels)], 1)
        y = self.transformer(src, sizes)
        tokens = list(y.split([h * w for h, w in sizes], dim=1))
        h8, w8 = sizes[-1]
        fine = tokens[-1].transpose(1, 2).reshape(b, -1, h8, w8)
        lateral = self.adapter_1(res[0])
        y4 = self.layer_1(lateral + F.interpolate(
            fine, size=lateral.shape[-2:], mode='bilinear',
            align_corners=False))
        return self.mask_features(y4), list(zip(tokens, sizes))


class Attention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``) over batch-first tokens, through
    ``F.scaled_dot_product_attention``; ``keep`` [B, 1, Lq, Lk] (true:
    attend) broadcasts over the heads."""

    def __init__(self, d: int, n_heads: int) -> None:
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, q, k, v, keep=None):
        b, lq, d = q.shape
        h = self.n_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w_, b_):
            return F.linear(x, w_, b_).view(b, -1, h, d // h).transpose(1, 2)
        o = F.scaled_dot_product_attention(heads(q, wq, bq), heads(k, wk, bk),
                                           heads(v, wv, bv), attn_mask=keep)
        return self.out_proj(o.transpose(1, 2).reshape(b, lq, d))


class CrossAttentionLayer(nn.Module):
    """Masked cross-attention of the queries to one level, post-norm."""

    def __init__(self, d: int, n_heads: int) -> None:
        super().__init__()
        self.multihead_attn = Attention(d, n_heads)
        self.norm = nn.LayerNorm(d)

    def forward(self, tgt, memory, keep, pos, query_pos):
        return self.norm(tgt + self.multihead_attn(
            tgt + query_pos, memory + pos, memory, keep))


class SelfAttentionLayer(nn.Module):
    def __init__(self, d: int, n_heads: int) -> None:
        super().__init__()
        self.self_attn = Attention(d, n_heads)
        self.norm = nn.LayerNorm(d)

    def forward(self, tgt, query_pos):
        q = tgt + query_pos
        return self.norm(tgt + self.self_attn(q, q, tgt))


class FFNLayer(nn.Module):
    def __init__(self, d: int, ffn: int) -> None:
        super().__init__()
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm = nn.LayerNorm(d)

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(F.relu(self.linear1(tgt))))


class MLP(nn.Module):
    def __init__(self, d: int, hidden: int, out: int, n_layers: int) -> None:
        super().__init__()
        dims = [d] + [hidden] * (n_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in
                                    zip(dims, dims[1:] + [out]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskedTransformerDecoder(nn.Module):
    """The queries through the masked-attention layers; returns the last
    layer's class logits [B, Q, C + 1] and mask logits [B, Q, H/4, W/4]."""

    def __init__(self, num_classes: int, hidden_dim: int = 256,
                 num_queries: int = 100, n_heads: int = 8, ffn: int = 2048,
                 n_layers: int = 9, mask_dim: int = 256) -> None:
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
        self.level_embed = nn.Embedding(LEVELS, hidden_dim)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)

    def forward(self, levels, mask_features: torch.Tensor):
        """levels: the pixel decoder's (tokens [B, h·w, C], (h, w)), 1/32
        first."""
        b, dt = mask_features.shape[0], mask_features.dtype
        src, pos = [], []
        for i, (tokens, (h, w)) in enumerate(levels):
            src.append(tokens + self.level_embed.weight[i])
            pos.append(const(sine_positions, h, w, tokens.shape[-1] // 2,
                             device=tokens.device).to(dt))
        output = self.query_feat.weight.unsqueeze(0).expand(b, -1, -1)
        query_pos = self.query_embed.weight
        n_layers = len(self.transformer_ffn_layers)
        masks, keep = self.predict_masks(output, mask_features, levels[0][1])
        for i in range(n_layers):
            lvl = i % LEVELS
            output = self.transformer_cross_attention_layers[i](
                output, src[lvl], keep, pos[lvl], query_pos)
            output = self.transformer_self_attention_layers[i](output,
                                                               query_pos)
            output = self.transformer_ffn_layers[i](output)
            size = (levels[(i + 1) % LEVELS][1]
                    if i < n_layers - 1 else None)
            masks, keep = self.predict_masks(output, mask_features, size)
        return self.class_embed(self.decoder_norm(output)), masks

    def predict_masks(self, output, mask_features, size):
        """The mask logits [B, Q, H/4, W/4] and, for a level of ``size``,
        its attention mask [B, 1, Q, h·w] (true: attend)."""
        emb = self.mask_embed(self.decoder_norm(output))
        masks = torch.einsum('bqc,bchw->bqhw', emb, mask_features)
        return masks, None if size is None else attention_keep(masks, size)


def attention_keep(masks: torch.Tensor, size: tuple[int, int]
                   ) -> torch.Tensor:
    """The attention mask of mask logits [B, Q, H, W] at a level of
    ``size``: [B, 1, Q, h·w], true where a query attends. The published
    ``sigmoid(resized) < 0.5`` blocks a key; that is ``resized < 0``. A
    query whose row blocks every key attends to all of them."""
    blocked = F.interpolate(masks, size=size, mode='bilinear',
                            align_corners=False).flatten(2) < 0
    return (~blocked | blocked.all(-1, keepdim=True)).unsqueeze(1)


class Mask2FormerModel(nn.Module):
    """Mask2Former for semantic segmentation; NHWC in and out. ``backbone``
    (default: the ResNet-50 at output stride 32) returns res2…res5 NCHW as
    its last four outputs, of ``in_channels``."""

    tileable = False

    def __init__(self, num_classes: int = 19,
                 backbone: nn.Module | None = None,
                 in_channels=(256, 512, 1024, 2048)) -> None:
        super().__init__()
        self.backbone = (ResNetEncoder(output_stride=32) if backbone is None
                         else backbone)
        self.pixel_decoder = MSDeformAttnPixelDecoder(in_channels)
        self.predictor = MaskedTransformerDecoder(num_classes)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        h, w = x.shape[1], x.shape[2]
        res = self.backbone(nhwc_to_nchw(x))[-4:]       # res2 … res5
        mask_features, levels = self.pixel_decoder(res)
        cls, masks = self.predictor(levels, mask_features)
        return {'segmentation': self.semantic_inference(cls, masks, (h, w))}

    def semantic_inference(self, cls: torch.Tensor, masks: torch.Tensor,
                           size: tuple[int, int]) -> torch.Tensor:
        """``einsum('bqc,bqhw->bhwc', softmax(cls)[..., :-1],
        sigmoid(masks upsampled to size))``, NHWC."""
        b = cls.shape[0]
        probs = F.softmax(cls, dim=-1)[..., :-1]
        up = F.interpolate(masks, size=size, mode='bilinear',
                           align_corners=False).sigmoid_()
        return torch.bmm(up.flatten(2).transpose(1, 2), probs).view(
            b, size[0], size[1], probs.shape[-1])


# Swin-L (ImageNet-22k, 384): the published Mask2Former Cityscapes model's
SWIN_L = {'embed_dim': 192, 'depths': (2, 2, 18, 2), 'heads': (6, 12, 24, 48),
          'window': 12, 'mlp_ratio': 4}


def mask2former_swin(num_classes: int = 19, **swin) -> Mask2FormerModel:
    """Mask2Former on a Swin backbone of :data:`SWIN_L`'s sizes, those in
    ``swin`` replaced."""
    s = {**SWIN_L, **swin}
    backbone = SwinTransformer(s['embed_dim'], s['depths'], s['heads'],
                               s['window'], s['mlp_ratio'])
    return Mask2FormerModel(num_classes, backbone, backbone.channels)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """The parts of the port's init (``factory.init_model``) that its
    generic rules do not cover: the attention in-projections like dense
    layers, the embeddings and level embeddings N(0, 1), GroupNorm as
    identity, and each ``MSDeformAttn`` as Deformable DETR starts it (zero
    offset and weight projections, the grid as the offsets' bias)."""
    for mod in model.modules():
        if isinstance(mod, Attention):
            nn.init.trunc_normal_(mod.in_proj_weight, std=0.02, a=-0.04,
                                  b=0.04, generator=generator)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(mod, DeformEncoder):
            mod.level_embed.normal_(0.0, 1.0, generator=generator)
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, MSDeformAttn):
            mod.sampling_offsets.weight.zero_()
            mod.sampling_offsets.bias.copy_(mod.grid())
            mod.attention_weights.weight.zero_()
            mod.attention_weights.bias.zero_()
