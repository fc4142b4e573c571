"""Device ms per batch of Mask2Former's semantic inference (span
``sweep.m2f_semseg`` on ``semantic_inference``): the masks upsampled to the
input, their sigmoid and the class product."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'sweep.m2f_semseg')
