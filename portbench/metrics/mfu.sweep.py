"""The sweep's share of the card's bf16 peak: the ensemble's forward FLOPs
(``counts/flops.py``) for the window's images over the traced window."""

from portbench.common.read import mfu


def read(ctx):
    return mfu(ctx)
