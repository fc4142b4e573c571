"""K15's (shifted-window attention, ``csrc/window_attention.cu``) share of
its roofline in the sweep: the least times of a forward's launches
(``counts/swin.py``; one a Swin block, in order) summed over the traced
launches, over their device time."""

from portbench.common.read import roofline
from portbench.counts.roofline import bound
from portbench.counts.swin import k15_counts, k15_launches


def read(ctx):
    t = ctx['traffic']
    if 'swin' not in ctx['config']:
        return None
    least = [bound(*k15_counts(*launch)) for launch in
             k15_launches(ctx['config'], t['batch'], t['height'],
                          t['width'])]
    return roofline(ctx, lambda n: 'window_attention' in n,
                    lambda i: least[i % len(least)])
