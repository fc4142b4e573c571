"""The plain reference model from a configuration, in f32, through the
builder of its ``model.type`` (``reference/builders/<type>.py``, which
builds from ``reference/models/`` alone)."""

from __future__ import annotations

import importlib
from typing import Any, Mapping

import torch


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    """The reference model on the meta device, from the builder
    ``reference/builders/<model.type>.py``."""
    kind = config['model']['type']
    name = f'{__package__}.builders.{kind}'
    try:
        builder = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ModuleNotFoundError(
            f'no reference builder for model type {kind!r}: add '
            f'portbench/reference/builders/{kind}.py', name=name) from None
    with torch.device('meta'):
        return builder.skeleton(config)


def load(model: torch.nn.Module, state: Mapping[str, torch.Tensor],
         device: str | torch.device) -> torch.nn.Module:
    """``model`` (on meta) holding f32 copies of ``state``'s values on
    ``device``, in eval mode."""
    model.load_state_dict({k: v.detach().to(device=device,
                                            dtype=torch.float32, copy=True)
                           for k, v in state.items()}, strict=True,
                          assign=True)
    return model.eval()


def build(config: Mapping[str, Any], state: Mapping[str, torch.Tensor],
          device: str | torch.device) -> torch.nn.Module:
    """The reference model in f32 on ``device`` holding copies of
    ``state``'s values, in eval mode."""
    return load(skeleton(config), state, device)
