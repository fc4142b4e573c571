"""The plain reference ensemble from a configuration, in f32."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from .models.ensemble import EnsembleModel


def build(config: Mapping[str, Any], state: Mapping[str, torch.Tensor],
          device: str | torch.device) -> EnsembleModel:
    """The reference ensemble in f32 on ``device`` holding copies of
    ``state``'s values, in eval mode."""
    m = config['model']
    with torch.device('meta'):
        model = EnsembleModel(m['num_classes'], m['include_depth'],
                              m['ensemble_strategy'],
                              m['temperature_scaling'], m['head_mode'],
                              m['segformer_variant'])
    model.load_state_dict({k: v.detach().to(device=device,
                                            dtype=torch.float32, copy=True)
                           for k, v in state.items()}, strict=True,
                          assign=True)
    return model.eval()
