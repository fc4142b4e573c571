"""The system under test: the port's model built from a configuration and
given the benchmark's weights, through the adapter of the configuration's
``model.type`` (``portbench/models/<type>.py``)."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..models import adapter


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    """The port's model on the meta device (no memory, no init)."""
    return adapter(config).skeleton(config)


def load(model: torch.nn.Module,
         state: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """``model`` (on meta) holding ``state``'s tensors, not copies, in eval
    mode."""
    model.load_state_dict(dict(state), strict=True, assign=True)
    return model.eval()


def build(config: Mapping[str, Any],
          state: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """The port's model holding ``state`` (its tensors, not copies), in eval
    mode."""
    return load(skeleton(config), state)
