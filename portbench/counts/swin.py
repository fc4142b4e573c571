"""Mask2Former-Swin-L's forward FLOPs per image and K15's least time, from
the configuration's sections (``configs/mask2former-swin-l.json``).

FLOPs as ``counts/mask2former.py`` counts them (two a multiply-add of the
products alone, as torch's ``FlopCounterMode``): the patch embedding; in
each block the qkv and output projections and the window attention's
scores and values over the map padded to windows, the MLP over the map
itself; the patch mergings' reductions. The head is
``counts/mask2former.py``'s ``pixel_decoder`` and ``decoder`` on the Swin's
stage outputs."""

from __future__ import annotations

from typing import Any, Mapping

from .flops import conv
from .mask2former import decoder, pixel_decoder

HEAD_DIM = 32


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def stages(height: int, width: int, sw: Mapping[str, Any]
           ) -> list[tuple[int, int, int, int, int]]:
    """Each stage's (h, w, channels, heads, depth) at an input of height ×
    width: 1/4 after the patch embedding, halved (rounded up) by each
    merging."""
    h, w = -(-height // 4), -(-width // 4)
    out = []
    for i, (depth, heads) in enumerate(zip(sw['depths'], sw['heads'])):
        out.append((h, w, sw['embed_dim'] * 2 ** i, heads, depth))
        h, w = -(-h // 2), -(-w // 2)
    return out


def swin(height: int, width: int, sw: Mapping[str, Any]
         ) -> tuple[float, list[tuple[int, int, int]]]:
    """The backbone's FLOPs and each stage's output (h, w, channels)."""
    ws, n = sw['window'], sw['window'] ** 2
    st = stages(height, width, sw)
    total = conv(st[0][0], st[0][1], 3, sw['embed_dim'], 4)
    for i, (h, w, c, _, depth) in enumerate(st):
        tp, t = _up(h, ws) * _up(w, ws), h * w
        block = (2.0 * tp * c * 3 * c + 4.0 * tp * n * c + 2.0 * tp * c * c
                 + 4.0 * t * c * int(c * sw['mlp_ratio']))
        total += depth * block
        if i + 1 < len(st):
            h2, w2 = st[i + 1][:2]
            total += 2.0 * h2 * w2 * 4 * c * 2 * c
    return total, [s[:3] for s in st]


def forward_flops(config: Mapping[str, Any], height: int,
                  width: int) -> float:
    bb_flops, res = swin(height, width, config['swin'])
    pd = config['pixel_decoder']
    return (bb_flops + pixel_decoder(res, pd)
            + decoder(res, config['decoder'], pd['mask_dim'],
                      config['model']['num_classes'], height, width))


def k15_counts(b: int, hp: int, wp: int, heads: int, window: int
               ) -> tuple[float, float]:
    """(operations, bytes) of one K15 launch in bf16 over a map padded to
    hp × wp: the scores and the product, 4·Tp·N·C; q, k and v read once,
    the output written once, the bias table read once."""
    tp, c = b * hp * wp, heads * HEAD_DIM
    return (4.0 * tp * window * window * c,
            2.0 * 4 * tp * c + 2.0 * (2 * window - 1) ** 2 * heads)


def k15_launches(config: Mapping[str, Any], batch: int, height: int,
                 width: int) -> list[tuple[int, int, int, int, int]]:
    """The (b, hp, wp, heads, window) of each K15 launch of one forward, in
    order: one a block."""
    sw = config['swin']
    ws = sw['window']
    return [(batch, _up(h, ws), _up(w, ws), heads, ws)
            for h, w, _, heads, depth in stages(height, width, sw)
            for _ in range(depth)]
