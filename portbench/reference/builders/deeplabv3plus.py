"""DeepLabV3+ alone: the reference's ResNet-50, ASPP and decoder."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..models.deeplab import DeepLabV3PlusModel


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    m = config['model']
    return DeepLabV3PlusModel(m['num_classes'], m['include_depth'])
