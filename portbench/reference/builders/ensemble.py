"""The SegFormer + DeepLabV3+ ensemble's reference."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..models.ensemble import EnsembleModel


def model_kwargs(config: Mapping[str, Any]) -> dict[str, Any]:
    """The ensemble's constructor arguments from a configuration file's
    ``model`` section (the port's and the reference's take the same)."""
    m = config['model']
    return dict(num_classes=m['num_classes'],
                include_depth=m['include_depth'],
                ensemble_strategy=m['ensemble_strategy'],
                temperature_scaling=m['temperature_scaling'],
                head_mode=m['head_mode'],
                segformer_variant=m['segformer_variant'])


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    return EnsembleModel(**model_kwargs(config))
