"""K1's (SR attention, ``csrc/sr_attention.cu``) share of its roofline in
the sweep: each launch's least time at its stage's shape (MiT's launches
in stage order, repeated per forward) over the launches' device time."""

from portbench.common.read import roofline
from portbench.counts.roofline import bound, k1_counts, k1_launches


def read(ctx):
    t, sf = ctx['traffic'], ctx['config']['segformer']
    shapes = k1_launches(t['batch'], t['height'], t['width'],
                         sf['hidden_sizes'], sf['depths'], sf['num_heads'],
                         sf['sr_ratios'])
    least = [bound(*k1_counts(*s)) for s in shapes]
    return roofline(ctx, lambda n: 'sr_attention' in n,
                    lambda i: least[i % len(least)])
