"""Device ms per batch of Mask2Former's masked-attention decoder (span
``sweep.m2f_decoder`` on its ``forward``): the nine layers and the ten mask
predictions."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'sweep.m2f_decoder')
