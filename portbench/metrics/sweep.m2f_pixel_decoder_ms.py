"""Device ms per batch of Mask2Former's pixel decoder (span
``sweep.m2f_pixel_decoder`` on its ``forward``): the input projections, the
six deformable encoder layers, the 1/4 output and the mask features."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'sweep.m2f_pixel_decoder')
