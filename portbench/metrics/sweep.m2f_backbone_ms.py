"""Device ms per batch of Mask2Former's ResNet-50 backbone (span
``sweep.m2f_backbone`` on its ``forward``)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'sweep.m2f_backbone')
