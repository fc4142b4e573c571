"""Device ms per step of the optimiser (``train/optim.py::Optimizer.step``:
the global-norm clip and AdamW)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'train.optim')
