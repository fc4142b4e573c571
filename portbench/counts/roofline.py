"""Least times of the port's kernels from their shapes, on one H100.

A frozen copy of ``chip_smoke.py``'s roofline arithmetic: the peaks
(``chip_smoke.py:206``), ``bound`` (``:285``), ``seg_bounds`` (``:386``),
K1's counts (``:527``, in ``phase_kernels``) and K8's (in
``seg_train_kernels``, called from ``phase_train_kernels`` ``:809``). A
kernel's least time is the larger of its operations over the bf16 peak and
its bytes over the HBM bandwidth; its roofline share is the least time
over its device time.
"""

from __future__ import annotations

BF16_PEAK, HBM_BW = 989e12, 3.35e12     # H100 SXM data sheet, 700 W


def bound(flops: float, nbytes: float, peak: float = BF16_PEAK) -> float:
    """Least seconds of ``flops`` operations and ``nbytes`` bytes."""
    return max(flops / peak, nbytes / HBM_BW)


def k1_counts(g: int, n: int, m: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one SR-attention launch in bf16: q [g, n, d],
    k and v [g, m, d] read, the output [g, n, d] written."""
    return 4.0 * g * n * m * d, 2.0 * (2 * g * n * d + 2 * g * m * d)


def k1_launches(batch: int, height: int, width: int, hidden_sizes,
                depths, num_heads, sr_ratios) -> list[tuple[int, int, int, int]]:
    """The (g, n, m, d) of every K1 launch of one MiT forward, in order:
    ``depths[i]`` launches at stage i, with ``batch·heads`` groups, the
    stage's tokens and the spatial-reduced K/V tokens."""
    out = []
    for i, (c, depth, heads, sr) in enumerate(zip(hidden_sizes, depths,
                                                  num_heads, sr_ratios)):
        h, w = height >> (i + 2), width >> (i + 2)
        m = -(-h // sr) * -(-w // sr)
        out += [(batch * heads, h * w, m, c // heads)] * depth
    return out


def seg_counts(b: int, h: int, w: int, c: int, nc: int, r: int
               ) -> tuple[float, float]:
    """(operations, bytes) of the eval seg head's core (K2) at P [b, h, w,
    9, c] → [b, h·r, w·r, nc] in bf16: the factorised passes' operations;
    P and wp read, the logits written (``seg_bounds``)."""
    pix = b * h * r * w * r
    flops = pix * (2 * 9 * 9 * c / r + 2 * 9 * c + 2 * c * nc)
    nbytes = b * h * w * 9 * c * 2 + c * nc * 2 + pix * nc * 2
    return flops, nbytes


def k8_counts(b: int, h: int, w: int, c: int, nc: int, r: int
              ) -> tuple[float, float]:
    """(operations, bytes) of the train seg head's backward (K8 and its
    reduce): twice K7's operations; P and the logits' gradient read, dpp
    (9× P) written, the f32 per-channel and class vectors."""
    pix = b * h * r * w * r
    flops7 = pix * (2 * 9 * 9 * c / r + 2 * 9 * c + 2 * c * nc)
    p_bytes = b * h * w * 9 * c * 2
    return (2 * flops7, p_bytes + pix * nc * 2 + 9 * p_bytes
            + (2 * c + c * nc + nc) * 4)
