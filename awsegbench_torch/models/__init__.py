"""SegFormer-B0 + DeepLabV3+ (ResNet-50) ensemble, eval mode."""

from .ensemble import EnsembleModel
from .factory import count_parameters, create_model

__all__ = ['EnsembleModel', 'count_parameters', 'create_model']
