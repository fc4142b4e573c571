"""Heuristic monocular depth estimate, the train step's depth target (a
frozen copy of the port's ``weather/depth.py``): vertical perspective
gradient, sky (top third) → 1.0, road (bottom half) ×0.5, minus
0.3·|Laplacian(gray)|/max per image, clipped to [0, 1], then a
scipy-border Gaussian (σ = 2) and a final clip.
"""

from __future__ import annotations

import torch

from ..ops.filters import gaussian_filter_scipy, laplacian, rgb_to_gray_cv_u8


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


