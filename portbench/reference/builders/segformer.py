"""SegFormer alone: the reference's MiT encoder and heads."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..models.segformer import SegFormerModel, mit_variant_config


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    m = config['model']
    hidden_sizes, depths = mit_variant_config(m['segformer_variant'])
    return SegFormerModel(m['num_classes'], m['include_depth'],
                          m['head_mode'], hidden_sizes, depths)
