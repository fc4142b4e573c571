"""Device ms per batch of Mask2Former's masked cross-attention: the nine
decoder layers' (span ``sweep.m2f_masked_attn`` on each one's ``forward``:
the projections, SDPA under the mask, the norm). The spans' device time is
summed over a batch's calls and divided by the batches traced; None where it
never opened or launched nothing."""


def read(ctx):
    seconds, calls = ctx['trace'].span_device('sweep.m2f_masked_attn')
    batches = ctx['units'] / ctx['traffic']['batch']
    if not calls or seconds <= 0.0 or not batches:
        return None
    return seconds / batches * 1e3
