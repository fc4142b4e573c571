"""K11's (multi-scale deformable sampling, ``csrc/ms_deform_attn.cu``)
share of its roofline in the sweep: each launch's least time at the
configuration's shape (``counts/mask2former.py``; every encoder layer's
launch alike) over the launches' device time."""

from portbench.common.read import roofline
from portbench.counts.mask2former import k11_counts, k11_launch
from portbench.counts.roofline import bound


def read(ctx):
    t = ctx['traffic']
    if 'pixel_decoder' not in ctx['config']:
        return None
    least = bound(*k11_counts(*k11_launch(ctx['config'], t['batch'],
                                          t['height'], t['width'])))
    return roofline(ctx, lambda n: 'ms_deform_attn' in n, lambda i: least)
