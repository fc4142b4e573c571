"""Mask2Former-R50 alone: the reference's Mask2Former, its deformable
attention's ``sampling_offsets.bias`` given the published grid on load."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..models.mask2former import Mask2FormerModel, MSDeformAttn, sampling_grid


def add_grid(module: MSDeformAttn, state_dict, prefix, *args) -> None:
    """A load pre-hook: the state's ``sampling_offsets.bias`` plus the
    grid (a new tensor; the caller's is left as it is)."""
    key = prefix + 'sampling_offsets.bias'
    if key in state_dict:
        v = state_dict[key]
        state_dict[key] = v + sampling_grid(
            module.n_heads, module.n_levels, module.n_points).to(
                device=v.device, dtype=v.dtype)


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    model = Mask2FormerModel(config['model']['num_classes'])
    for mod in model.modules():
        if isinstance(mod, MSDeformAttn):
            mod.register_load_state_dict_pre_hook(add_grid)
    return model
