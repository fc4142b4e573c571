"""Device ms per batch of the Swin backbone's window attention: the 24
blocks' ``WindowAttention`` (span ``sweep.swin_attn`` on each one's
``forward``: the qkv projection, K15, the output projection). The spans'
device time is summed over a batch's calls and divided by the batches
traced; None where it never opened or launched nothing."""


def read(ctx):
    seconds, calls = ctx['trace'].span_device('sweep.swin_attn')
    batches = ctx['units'] / ctx['traffic']['batch']
    if not calls or seconds <= 0.0 or not batches:
        return None
    return seconds / batches * 1e3
