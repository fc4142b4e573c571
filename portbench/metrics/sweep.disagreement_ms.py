"""Device ms per batch of the members' disagreement, the mean softmax's
errors and the AUROC histogram (span ``sweep.disagreement`` in
``Evaluator.accumulate``)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'sweep.disagreement')
