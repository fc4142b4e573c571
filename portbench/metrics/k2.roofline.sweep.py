"""K2's (the eval seg head, ``csrc/seg_head.cu``) share of its roofline in
the sweep: one launch per forward at P [batch, H/32, W/32, 9, 256]."""

from portbench.common.read import roofline
from portbench.counts.roofline import bound, seg_counts


def read(ctx):
    t, cfg = ctx['traffic'], ctx['config']
    least = bound(*seg_counts(t['batch'], t['height'] // 32,
                              t['width'] // 32,
                              cfg['segformer']['seg_head_hidden'],
                              cfg['model']['num_classes'], 32))
    return roofline(ctx, lambda n: 'seg_head_mma' in n
                    or 'seg_head_kernel' in n, lambda i: least)
