"""Device-side batch preparation (counterpart of ``prepare_batch`` and
``normalize_imagenet`` in ``awsegbench/data/pipeline.py``), eval mode.

Train-time augmentation (``_train_augment``) arrives with the train step.
"""

from __future__ import annotations

import torch

from .._device import const
from ..weather.corruption import apply_corruption, draw_corruption
from ..weather.depth import estimate_depth_batch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(images_u8: torch.Tensor) -> torch.Tensor:
    """(x/255 − mean)/std, NHWC float32."""
    mean = const(tuple, IMAGENET_MEAN, device=images_u8.device)
    std = const(tuple, IMAGENET_STD, device=images_u8.device)
    return (images_u8.to(torch.float32) / 255.0 - mean) / std


def prepare_batch(images_u8: torch.Tensor, labels: torch.Tensor,
                  weather_ids: torch.Tensor,
                  generator: torch.Generator | None = None,
                  draws: dict[str, torch.Tensor] | None = None,
                  include_depth: bool = True) -> dict[str, torch.Tensor]:
    """Corrupt → (estimate depth) → normalize, on the images' device.

    The corruption draws come from ``generator`` (a ``torch.Generator`` on
    the images' device), or are given as ``draws`` (as from
    :func:`~awsegbench_torch.weather.corruption.draw_corruption`).
    Returns {image: float32 NHWC normalized, label, weather_id, depth?}.
    """
    if draws is None:
        if generator is None:
            raise ValueError('prepare_batch needs a generator or draws')
        draws = draw_corruption(weather_ids, images_u8.shape[1],
                                images_u8.shape[2], generator)
    corrupted = apply_corruption(images_u8, weather_ids, draws)
    out = {'image': normalize_imagenet(corrupted), 'label': labels,
           'weather_id': weather_ids}
    if include_depth:
        out['depth'] = estimate_depth_batch(corrupted)
    return out
