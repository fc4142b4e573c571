"""Device-side batch preparation (counterpart of ``prepare_batch``,
``_train_augment`` and ``normalize_imagenet`` in
``awsegbench/data/pipeline.py``).

As the corruption, the train-time augmentation is split into its draws
(:func:`draw_augment`, from an explicit ``torch.Generator``) and a
deterministic apply (:func:`apply_augment`), so tests can hand the JAX
path's draws to the port.
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


def draw_augment(batch: int, generator: torch.Generator,
                 device: torch.device) -> dict[str, torch.Tensor]:
    """The draws of ``_train_augment`` for ``batch`` images: horizontal flip
    with p 0.5; brightness/contrast with p 0.3, contrast factor
    ``alpha = 1 + U(−0.2, 0.2)`` and brightness ``beta = U(−0.2, 0.2)``."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((batch,), generator=generator,
                                           device=device)
    return {'do_flip': u(0.0, 1.0) < 0.5, 'do_bc': u(0.0, 1.0) < 0.3,
            'alpha': 1.0 + u(-0.2, 0.2), 'beta': u(-0.2, 0.2)}


def apply_augment(images_u8: torch.Tensor, labels: torch.Tensor,
                  draws: dict[str, torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """HorizontalFlip + RandomBrightnessContrast with the given draws, per
    image: ``clip(round(x·alpha + beta·255), 0, 255)`` (round half to even,
    as JAX)."""
    flip = draws['do_flip']
    images_u8 = torch.where(flip[:, None, None, None], images_u8.flip(2),
                            images_u8)
    labels = torch.where(flip[:, None, None], labels.flip(2), labels)
    adjusted = (images_u8.float() * draws['alpha'][:, None, None, None]
                + (draws['beta'] * 255.0)[:, None, None, None])
    adjusted = torch.clamp(torch.round(adjusted), 0, 255).to(torch.uint8)
    images_u8 = torch.where(draws['do_bc'][:, None, None, None], adjusted,
                            images_u8)
    return images_u8, labels


def prepare_batch(images_u8: torch.Tensor, labels: torch.Tensor,
                  weather_ids: torch.Tensor,
                  generator: torch.Generator | None = None,
                  draws: dict[str, torch.Tensor] | None = None,
                  include_depth: bool = True, train: bool = False,
                  apply_augmentation: bool = True,
                  aug_draws: dict[str, torch.Tensor] | None = None
                  ) -> dict[str, torch.Tensor]:
    """Corrupt → (estimate depth) → (augment, in train mode) → normalize,
    on the images' device.

    The corruption draws come from ``generator`` (a ``torch.Generator`` on
    the images' device), or are given as ``draws`` (as from
    :func:`~awsegbench_torch.weather.corruption.draw_corruption`); the
    augmentation's likewise, or as ``aug_draws`` (:func:`draw_augment`).
    Depth is estimated before the flip, as in the JAX package.
    Returns {image: float32 NHWC normalized, label, weather_id, depth?}.
    """
    augment = train and apply_augmentation
    if (draws is None or (augment and aug_draws is None)) and generator is None:
        raise ValueError('prepare_batch needs a generator or draws')
    if draws is None:
        draws = draw_corruption(weather_ids, images_u8.shape[1],
                                images_u8.shape[2], generator)
    corrupted = apply_corruption(images_u8, weather_ids, draws)
    depth = estimate_depth_batch(corrupted) if include_depth else None
    if augment:
        if aug_draws is None:
            aug_draws = draw_augment(images_u8.shape[0], generator,
                                     images_u8.device)
        corrupted, labels = apply_augment(corrupted, labels, aug_draws)
    out = {'image': normalize_imagenet(corrupted), 'label': labels,
           'weather_id': weather_ids}
    if depth is not None:
        out['depth'] = depth
    return out
