"""The device's idle share of the train step's traced window."""

from portbench.common.read import idle


def read(ctx):
    return idle(ctx)
