"""The device's idle share of the served requests' traced window."""

from portbench.common.read import idle


def read(ctx):
    return idle(ctx)
