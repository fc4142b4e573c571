"""Training: the trainer, early stopping, optimisers and schedulers,
checkpoints, and the benchmark's train step.

``TrainState`` of the JAX package's list has no counterpart: it is Flax's
own; the port keeps the model, its ``Optimizer`` and the trainer's
counters instead.
"""

from .checkpoints import CheckpointManager, load_checkpoint
from .optim import (
    CosineAnnealingLR,
    ReduceLROnPlateau,
    StepLR,
    create_optimizer,
    create_scheduler,
    get_learning_rate,
    set_learning_rate,
)
from .trainer import (
    AdverseWeatherTrainer,
    EarlyStopping,
    fog_density_from_weather,
)

__all__ = [
    "AdverseWeatherTrainer", "EarlyStopping",
    "fog_density_from_weather", "CheckpointManager", "load_checkpoint",
    "create_optimizer", "create_scheduler", "set_learning_rate",
    "get_learning_rate", "CosineAnnealingLR", "StepLR", "ReduceLROnPlateau",
]
