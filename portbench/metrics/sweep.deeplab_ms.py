"""Device ms per batch of the DeepLabV3+ member's forward."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'sweep.deeplab')
