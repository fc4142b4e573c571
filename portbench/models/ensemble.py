"""The SegFormer + DeepLabV3+ ensemble (the factory's ``ensemble`` type):
both members, their weighted average over a temperature, and the members'
logits for the sweep's disagreement."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..reference.builders.ensemble import model_kwargs
from . import deeplabv3plus, segformer

OUTPUTS = ('segmentation', 'segformer_seg', 'deeplabv3plus_seg')
MEMBERS = ('segformer_seg', 'deeplabv3plus_seg')


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    from awsegbench_torch.models.ensemble import EnsembleModel
    with torch.device('meta'):
        return EnsembleModel(**model_kwargs(config))


def sizes(model: torch.nn.Module) -> dict:
    return {'segformer': segformer.section(model.segformer),
            **deeplabv3plus.sizes(model.deeplabv3plus)}


def forward_flops(config: Mapping[str, Any], height: int,
                  width: int) -> float:
    return (segformer.forward_flops(config, height, width)
            + deeplabv3plus.forward_flops(config, height, width))


def spans(model: torch.nn.Module) -> list[tuple]:
    return [(model.segformer, 'forward', 'sweep.segformer'),
            (model.deeplabv3plus, 'forward', 'sweep.deeplab')]
