"""K8's (the train seg head's backward, ``csrc/seg_head_train.cu``:
``seg_bwd_mma`` for the seg head and its ``seg_train_reduce``) share of its
roofline in the train step: one call per step at P [batch, H/32, W/32, 9,
256]; the depth head's backward (K10) shares the body with ``kSeg`` false
and is not counted."""

from portbench.counts.roofline import bound, k8_counts


def is_main(name):
    return 'seg_bwd_mma<true' in name.replace(' ', '')


def read(ctx):
    t, cfg = ctx['traffic'], ctx['config']
    trace = ctx['trace']
    main = trace.ops_named(is_main)
    ops = main + trace.ops_named(lambda n: 'seg_train_reduce' in n)
    device = sum(e - s for _, s, e, _ in ops)
    if not main or device <= 0.0:
        return None
    least = bound(*k8_counts(t['batch'], t['height'] // 32, t['width'] // 32,
                             cfg['segformer']['seg_head_hidden'],
                             cfg['model']['num_classes'], 32))
    return 100.0 * len(main) * least / device
