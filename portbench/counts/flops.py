"""A model's forward FLOPs per image, from its configuration's shapes: the
counts of the ensemble's parts (MiT, the faithful heads, DeepLabV3+), which
each model type's adapter (``portbench/models/``) sums for its model.

Two FLOPs per multiply-add of every convolution, dense layer and attention
product; elementwise work (norms, activations, softmax, resizes) is not
counted. The faithful heads' first conv over the ×scale bilinear upsample
is counted as the operations the function needs (the phase form of the
port's ``ops/upconv.py`` and of K2 and K7: the coarse partial products, a
9-tap pass along y on the coarse columns and a 9-tap pass along x), never
as a 3×3 conv at full resolution; the four 1-px border lines are not
counted apart. A train step counts three forwards (the backward twice the
forward). Whatever kernel runs, this count stays.
"""

from __future__ import annotations

from typing import Any, Mapping


def conv(h: int, w: int, cin: int, cout: int, k: int = 1,
         groups: int = 1) -> float:
    """FLOPs of a k×k conv with an h×w output."""
    return 2.0 * h * w * (cin // groups) * cout * k * k


def upsample_conv(hf: int, wf: int, cin: int, cout: int, r: int) -> float:
    """``conv3x3(bilinear_upsample_×r(f))`` of f [hf, wf, cin] in the phase
    form: 9 partial products per coarse pixel, 9 taps per element of the
    y pass ([hf·r, wf, 3, cout]) and of the x pass ([hf·r, wf·r, cout])."""
    return (conv(hf, wf, cin, 9 * cout) + 2.0 * hf * r * wf * 3 * cout * 9
            + 2.0 * hf * r * wf * r * cout * 9)


def mit(height: int, width: int, sf: Mapping[str, Any]) -> float:
    """The MiT encoder: patch embeds, then per block q, the spatial-
    reduction conv, k, v, q·kᵀ, p·v, the output projection and Mix-FFN
    (dense, depthwise 3×3, dense)."""
    total, cin = 0.0, 3
    h, w = height, width
    for i, c in enumerate(sf['hidden_sizes']):
        k, s = sf['patch_sizes'][i], sf['strides'][i]
        h, w = -(-h // s), -(-w // s)
        total += conv(h, w, cin, c, k)
        n, sr = h * w, sf['sr_ratios'][i]
        m = -(-h // sr) * -(-w // sr)
        hid = c * sf['mlp_ratios'][i]
        block = (2.0 * n * c * c * 2            # q, output projection
                 + (conv(m, 1, c, c, sr) if sr > 1 else 0.0)
                 + 2.0 * m * c * c * 2          # k, v
                 + 2.0 * n * m * c * 2          # q·kᵀ, p·v (all heads)
                 + 2.0 * n * c * hid * 2        # Mix-FFN's dense layers
                 + conv(h, w, hid, hid, 3, groups=hid))
        total += block * sf['depths'][i]
        cin = c
    return total


def segformer_heads(height: int, width: int, sf: Mapping[str, Any],
                    num_classes: int, include_depth: bool) -> float:
    """The faithful seg head (upsample-conv → BN → ReLU → 1×1) and depth
    head (upsample-conv → BN → ReLU → 3×3 → BN → ReLU → 1×1) on the last
    stage's features, upsampled ×32 to the input."""
    cin, r = sf['hidden_sizes'][-1], 32
    hf, wf = height // r, width // r
    hs, hd = sf['seg_head_hidden'], sf['depth_head_hidden']
    total = (upsample_conv(hf, wf, cin, hs, r)
             + conv(height, width, hs, num_classes))
    if include_depth:
        total += (upsample_conv(hf, wf, cin, hd, r)
                  + conv(height, width, hd, hd // 2, 3)
                  + conv(height, width, hd // 2, 1))
    return total


def deeplab(height: int, width: int, dl: Mapping[str, Any],
            num_classes: int, include_depth: bool) -> float:
    """ResNet-50 (stem, bottlenecks at the output stride's strides and
    dilations), ASPP (1×1, three separable atrous branches, image pooling,
    projection), the ×4 decoder and the depth head at the output stride."""
    h, w = -(-height // 2), -(-width // 2)
    total = conv(h, w, 3, 64, 7)
    h, w = -(-h // 2), -(-w // 2)                       # max-pool
    strides = {16: (1, 2, 2, 1), 8: (1, 2, 1, 1), 32: (1, 2, 2, 2)}[
        dl['output_stride']]
    cin, low = 64, None
    for stage, (blocks, f) in enumerate(zip(dl['layers'], dl['widths'])):
        for i in range(blocks):
            s = strides[stage] if i == 0 else 1
            ho, wo = -(-h // s), -(-w // s)
            total += (conv(h, w, cin, f) + conv(ho, wo, f, f, 3)
                      + conv(ho, wo, f, 4 * f)
                      + (conv(ho, wo, cin, 4 * f) if i == 0 else 0.0))
            h, w, cin = ho, wo, 4 * f
        if stage == 0:
            low = (h, w, cin)
    dc, rates = dl['decoder_channels'], dl['atrous_rates']
    total += (conv(h, w, cin, dc)
              + len(rates) * (conv(h, w, cin, cin, 3, groups=cin)
                              + conv(h, w, cin, dc))
              + conv(1, 1, cin, dc)
              + conv(h, w, dc * (len(rates) + 2), dc))
    total += conv(h, w, dc, dc, 3, groups=dc) + conv(h, w, dc, dc)
    lh, lw, lc = low
    ll = dl['low_level_channels']
    total += (conv(lh, lw, lc, ll) + conv(lh, lw, dc + ll, dc + ll, 3,
                                          groups=dc + ll)
              + conv(lh, lw, dc + ll, dc) + conv(lh, lw, dc, num_classes))
    if include_depth:
        hd = dl['depth_head_hidden']
        total += (conv(h, w, cin, hd, 3) + conv(h, w, hd, hd // 2, 3)
                  + conv(h, w, hd // 2, 1))
    return total


def forward_flops(config: Mapping[str, Any], height: int, width: int) -> float:
    """FLOPs of one image's forward at ``height`` × ``width``: the sum the
    adapter of the configuration's model type makes of the counts above."""
    from ..models import adapter
    return adapter(config).forward_flops(config, height, width)


def train_flops(config: Mapping[str, Any], height: int, width: int) -> float:
    """FLOPs of one image's train step: the forward and a backward of
    twice its operations."""
    return 3.0 * forward_flops(config, height, width)
