"""Batch preparation of the plain reference (a frozen copy of
``awsegbench_torch/data/pipeline.py``'s device side): corrupt → estimate
depth → augment (train) → ImageNet normalisation."""

from __future__ import annotations

import torch

from ._device import const
from .weather.corruption import apply_corruption
from .weather.depth import estimate_depth_batch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(images_u8: torch.Tensor) -> torch.Tensor:
    """(x/255 − mean)/std, NHWC float32."""
    mean = const(tuple, IMAGENET_MEAN, device=images_u8.device)
    std = const(tuple, IMAGENET_STD, device=images_u8.device)
    return (images_u8.to(torch.float32) / 255.0 - mean) / std


def draw_augment(batch: int, generator: torch.Generator,
                 device: torch.device) -> dict[str, torch.Tensor]:
    """Horizontal flip with p 0.5; brightness/contrast with p 0.3,
    ``alpha = 1 + U(−0.2, 0.2)``, ``beta = U(−0.2, 0.2)``."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((batch,), generator=generator,
                                           device=device)
    return {'do_flip': u(0.0, 1.0) < 0.5, 'do_bc': u(0.0, 1.0) < 0.3,
            'alpha': 1.0 + u(-0.2, 0.2), 'beta': u(-0.2, 0.2)}


def apply_augment(images_u8: torch.Tensor, labels: torch.Tensor,
                  draws: dict[str, torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flip and ``clip(round(x·alpha + beta·255), 0, 255)`` per image."""
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
                  weather_ids: torch.Tensor, draws: dict[str, torch.Tensor],
                  include_depth: bool = False,
                  aug_draws: dict[str, torch.Tensor] | None = None
                  ) -> dict[str, torch.Tensor]:
    """{image: f32 NHWC normalised, label, depth?} of a uint8 batch; the
    depth target is estimated before the flip."""
    corrupted = apply_corruption(images_u8, weather_ids, draws)
    depth = estimate_depth_batch(corrupted) if include_depth else None
    if aug_draws is not None:
        corrupted, labels = apply_augment(corrupted, labels, aug_draws)
    out = {'image': normalize_imagenet(corrupted), 'label': labels}
    if depth is not None:
        out['depth'] = depth
    return out
