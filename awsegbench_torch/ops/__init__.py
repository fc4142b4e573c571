"""Tensor ops and the hand-written CUDA kernels, each an ``awseg::`` op.

Importing these builds and loads no kernel: a kernel's library is built
with ``nvcc`` at its first launch on a CUDA tensor (``_build.py``). The
JAX package's ``sr_attention_reference`` is ``sr_attention_plain`` here.
Importing the package registers the custom ops of ``library.py``.
"""

from .attention import sr_attention, sr_attention_plain
from .depthkernels_train import depth_stage1_fused_train
from .filters import (
    box_filter,
    depthwise_conv3x3,
    gaussian_blur_cv,
    gaussian_filter_scipy,
    laplacian,
    local_contrast,
    percentile,
    rgb_to_gray_cv,
    rgb_to_gray_cv_u8,
    separable_filter,
)
from .headkernels import seg_head_fused
from .headkernels_train import seg_head_fused_train
from .resize import resize_bilinear, resize_linear, resize_nearest, upsample_like
from .upconv import upsample_conv3x3

from . import library  # noqa: F401  (registers the awseg:: ops)

__all__ = [
    "gaussian_blur_cv", "gaussian_filter_scipy", "box_filter", "laplacian",
    "local_contrast", "rgb_to_gray_cv", "rgb_to_gray_cv_u8",
    "separable_filter", "depthwise_conv3x3", "percentile",
    "resize_bilinear", "resize_linear", "resize_nearest", "upsample_like",
    "upsample_conv3x3", "seg_head_fused",
    "seg_head_fused_train", "depth_stage1_fused_train",
    "sr_attention", "sr_attention_plain",
]
