"""Heuristic monocular depth estimate (counterpart of
``awsegbench/weather/depth.py``).

Vertical perspective gradient, sky (top third) → 1.0, road (bottom half)
×0.5, minus 0.3·|Laplacian(gray)|/max per image, clipped to [0, 1], then a
scipy-border Gaussian (σ = 2) and a final clip. Then depth → disparity and
the resize and min-max normalisation for training.
"""

from __future__ import annotations

import torch

from ..ops.filters import gaussian_filter_scipy, laplacian, rgb_to_gray_cv_u8
from ..ops.resize import resize_linear


def estimate_depth_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 → [B, H, W] float32 in [0, 1]."""
    b, h, w, _ = images_u8.shape
    dev = images_u8.device
    gray = rgb_to_gray_cv_u8(images_u8).to(torch.float32)      # [B, H, W, 1]

    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    base = (rows / h * 0.8 + 0.2).expand(h, w)
    depth = torch.where(rows < (h // 3), 1.0, base)
    depth = torch.where(rows >= (h // 2), depth * 0.5, depth)

    texture = laplacian(gray)[..., 0].abs()                     # [B, H, W]
    strength = texture / (texture.amax(dim=(1, 2), keepdim=True) + 1e-8)
    depth = torch.clamp(depth - 0.3 * strength, 0.0, 1.0)
    depth = gaussian_filter_scipy(depth[..., None], sigma=2.0)[..., 0]
    return torch.clamp(depth, 0.0, 1.0)


def estimate_depth(image_u8: torch.Tensor) -> torch.Tensor:
    """One image: [H, W, 3] uint8 → [H, W] float32 in [0, 1]."""
    return estimate_depth_batch(image_u8[None])[0]


def depth_to_disparity(depth: torch.Tensor,
                       baseline: float = 0.54) -> torch.Tensor:
    """disparity = baseline / max(depth, 1e-6) (preprocessing.py:369-384)."""
    return baseline / torch.clamp(depth, min=1e-6)


def preprocess_depth_for_training(depth: torch.Tensor,
                                  target_size: tuple[int, int]
                                  ) -> torch.Tensor:
    """Resize (``jax.image.resize``'s linear, antialiased when it shrinks)
    and min-max normalise a depth map [H, W] (preprocessing.py:386-410)."""
    if tuple(depth.shape) != tuple(target_size):
        depth = resize_linear(depth, target_size)
    dmin, dmax = depth.min(), depth.max()
    return (depth - dmin) / (dmax - dmin + 1e-8)
