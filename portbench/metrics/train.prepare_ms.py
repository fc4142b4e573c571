"""Device ms per step of the train step's preparation (span ``train.prepare``
in ``TrainStep.__call__``: the batch and draws to the device, corruption,
augmentation, depth target, fog density, dropout seeds)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'train.prepare')
