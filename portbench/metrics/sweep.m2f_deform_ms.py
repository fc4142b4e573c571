"""Device ms per batch of Mask2Former's multi-scale deformable attention: the
six encoder layers' ``MSDeformAttn`` (span ``sweep.m2f_deform`` on each
one's ``forward``: the value, offset and weight projections, the f32
locations and softmax, K11, the output projection). The spans' device time
is summed over a batch's calls and divided by the batches traced; None where
it never opened or launched nothing."""


def read(ctx):
    seconds, calls = ctx['trace'].span_device('sweep.m2f_deform')
    batches = ctx['units'] / ctx['traffic']['batch']
    if not calls or seconds <= 0.0 or not batches:
        return None
    return seconds / batches * 1e3
