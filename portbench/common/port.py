"""The system under test: the port's ensemble built from a configuration
and given the benchmark's weights."""

from __future__ import annotations

from typing import Any, Mapping

import torch


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
    """The port's ensemble on the meta device (no memory, no init)."""
    from awsegbench_torch.models.ensemble import EnsembleModel
    with torch.device('meta'):
        return EnsembleModel(**model_kwargs(config))


def build(config: Mapping[str, Any],
          state: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """The port's ensemble holding ``state`` (its tensors, not copies), in
    eval mode."""
    model = skeleton(config)
    model.load_state_dict(dict(state), strict=True, assign=True)
    return model.eval()
