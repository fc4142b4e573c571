"""Mask2Former-R50's forward FLOPs per image and K11's least time, from
the configuration's sections (``configs/mask2former-r50.json``).

FLOPs: two a multiply-add of the products alone (convolutions, dense
layers, attention's scores and values, the deformable attention's
weighted sum of its samples, the mask and semantic einsums), as torch's
``FlopCounterMode`` counts them; norms, softmax, resizes and the bilinear
taps are not counted. The class head is counted once (the model skips the
intermediate ones); the mask MLP and the mask einsum once a prediction,
one before the first layer and one after each."""

from __future__ import annotations

from typing import Any, Mapping

from .flops import conv


def resnet(height: int, width: int, bb: Mapping[str, Any]
           ) -> tuple[float, list[tuple[int, int, int]]]:
    """The ResNet's FLOPs and each stage's output (h, w, channels)."""
    h, w = -(-height // 2), -(-width // 2)
    total = conv(h, w, 3, 64, 7)
    h, w = -(-h // 2), -(-w // 2)                       # max-pool
    strides = {16: (1, 2, 2, 1), 8: (1, 2, 1, 1), 32: (1, 2, 2, 2)}[
        bb['output_stride']]
    cin, outs = 64, []
    for stage, (blocks, f) in enumerate(zip(bb['layers'], bb['widths'])):
        for i in range(blocks):
            s = strides[stage] if i == 0 else 1
            ho, wo = -(-h // s), -(-w // s)
            total += (conv(h, w, cin, f) + conv(ho, wo, f, f, 3)
                      + conv(ho, wo, f, 4 * f)
                      + (conv(ho, wo, cin, 4 * f) if i == 0 else 0.0))
            h, w, cin = ho, wo, 4 * f
        outs.append((h, w, cin))
    return total, outs


def pixel_decoder(res, pd: Mapping[str, Any]) -> float:
    """Input projections, the deformable encoder over res5, res4, res3,
    the 1/4 lateral and output convs and the mask features."""
    d, mask_dim = pd['conv_dim'], pd['mask_dim']
    m, lv, p = pd['heads'], pd['levels'], pd['points']
    levels = res[:0:-1][:lv]
    n = sum(h * w for h, w, _ in levels)
    total = sum(conv(h, w, c, d) for h, w, c in levels)
    layer = (2.0 * n * d * d * 2                      # value, output proj
             + 2.0 * n * d * m * lv * p * 3           # offsets, weights
             + 2.0 * n * lv * p * d                   # weighted samples
             + 2.0 * n * d * pd['ffn_dim'] * 2)
    total += layer * pd['transformer_layers']
    h4, w4, c4 = res[0]
    return (total + conv(h4, w4, c4, d) + conv(h4, w4, d, d, 3)
            + conv(h4, w4, d, mask_dim))


def decoder(res, dec: Mapping[str, Any], mask_dim: int, num_classes: int,
            height: int, width: int) -> float:
    """The masked-attention layers, the mask predictions, the class head
    and the semantic einsum at the input's size."""
    q, d, n_layers = dec['num_queries'], dec['hidden_dim'], dec['layers']
    h4, w4, _ = res[0]
    keys = [h * w for h, w, _ in res[:0:-1]]          # 1/32, 1/16, 1/8
    total = 0.0
    for i in range(n_layers):
        k = keys[i % len(keys)]
        total += (2.0 * q * d * d * 2 + 2.0 * k * d * d * 2   # q, out; k, v
                  + 2.0 * q * k * d * 2                       # scores, p·v
                  + 2.0 * q * d * d * 4 + 2.0 * q * q * d * 2  # self-attn
                  + 2.0 * q * d * dec['ffn_dim'] * 2)
    mlp = 2.0 * q * d * d * (dec['mask_mlp_layers'] - 1) + 2.0 * q * d * mask_dim
    predictions = (n_layers + 1) * (mlp + 2.0 * q * mask_dim * h4 * w4)
    return (total + predictions + 2.0 * q * d * (num_classes + 1)
            + 2.0 * q * num_classes * height * width)


def forward_flops(config: Mapping[str, Any], height: int,
                  width: int) -> float:
    bb_flops, res = resnet(height, width, config['backbone'])
    pd = config['pixel_decoder']
    return (bb_flops + pixel_decoder(res, pd)
            + decoder(res, config['decoder'], pd['mask_dim'],
                      config['model']['num_classes'], height, width))


def k11_counts(b: int, lq: int, s: int, m: int, d: int, levels: int,
               points: int) -> tuple[float, float]:
    """(operations, bytes) of one K11 launch in bf16: four bilinear taps
    and the weight a point and channel (five multiply-adds); the value
    [b, s, m, d] read once, the f32 locations [b, lq, m, levels, points,
    2] and weights read once, the output [b, lq, m·d] written once."""
    pts = b * lq * m * levels * points
    return (10.0 * pts * d,
            2.0 * b * s * m * d + 4.0 * pts * 3 + 2.0 * b * lq * m * d)


def k11_launch(config: Mapping[str, Any], batch: int, height: int,
               width: int) -> tuple[int, ...]:
    """The (b, lq, s, m, d, levels, points) of each K11 launch of one
    forward (every encoder layer's is the same)."""
    pd = config['pixel_decoder']
    _, res = resnet(height, width, config['backbone'])
    n = sum(h * w for h, w, _ in res[:0:-1][:pd['levels']])
    return (batch, n, n, pd['heads'], pd['conv_dim'] // pd['heads'],
            pd['levels'], pd['points'])
