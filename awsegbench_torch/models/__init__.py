"""The models (SegFormer, DeepLabV3+, their ensemble and heads; NHWC in
and out), the factory and the pretrained-encoder grafting."""

from .deeplab import ASPP, DeepLabV3PlusModel, ResNetEncoder
from .ensemble import EnsembleModel
from .factory import (count_parameters, create_model, init_model,
                      init_model_variables)
from .heads import DepthEstimationHead, SegmentationHead
from .pretrained import apply_pretrained, find_weights_file, load_state_dict
from .segformer import (MIT_VARIANTS, MiTEncoder, SegFormerModel,
                        mit_variant_config, mit_variant_name)

__all__ = [
    "SegFormerModel", "MiTEncoder", "DeepLabV3PlusModel", "ResNetEncoder",
    "ASPP", "EnsembleModel", "DepthEstimationHead", "SegmentationHead",
    "create_model", "init_model", "init_model_variables",
    "count_parameters", "apply_pretrained", "find_weights_file",
    "load_state_dict", "MIT_VARIANTS", "mit_variant_config",
    "mit_variant_name",
]
