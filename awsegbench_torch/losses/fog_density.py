"""Fog-density-aware loss (counterpart of ``awsegbench/losses/fog_density.py``).

Per-pixel cross-entropy (or focal) reweighted by ``1 + fog_sensitivity ·
fog_density``, optional fog density derived from the predicted depth with a
gradient-based edge discount, and an MSE depth loss scaled by
``depth_loss_weight``. Returns {'total_loss', 'segmentation_loss',
'depth_loss'}.

Parity notes, kept from the JAX package:

* out-of-range targets (e.g. the ignore label 255) give zero loss, yet the
  mean still divides by *all* pixels; ``F.cross_entropy(ignore_index=…)``
  with its default mean would divide by the valid ones only;
* fog-from-depth applies only when no fog density is given and depth is
  predicted; the depth MSE only when a depth target exists.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def _per_pixel_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Cross entropy per pixel: logits [B, H, W, C] (NHWC), targets
    [B, H, W]; 0 where the target is outside [0, C)."""
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    in_range = (targets >= 0) & (targets < num_classes)
    t_safe = targets.clamp(0, num_classes - 1).long()
    nll = -logp.gather(-1, t_safe[..., None])[..., 0]
    return torch.where(in_range, nll, 0.0)


def _focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                alpha: float = 1.0, gamma: float = 2.0) -> torch.Tensor:
    """α·(1 − e^{−CE})^γ·CE per pixel."""
    ce = _per_pixel_ce(logits, targets)
    pt = torch.exp(-ce)
    return alpha * (1.0 - pt) ** gamma * ce


def estimate_fog_density_from_depth(depth: torch.Tensor) -> torch.Tensor:
    """Fog density heuristic from predicted depth [B, H, W]: depth
    normalised over the whole batch, ×0.7, minus 0.3 where the
    forward-difference gradient magnitude (replicate-padded at the trailing
    edge) exceeds its mean, clipped to [0, 1]."""
    dmin, dmax = depth.min(), depth.max()
    fog_density = (depth - dmin) / (dmax - dmin + 1e-8) * 0.7
    gx = (depth[:, :, 1:] - depth[:, :, :-1]).abs()
    gy = (depth[:, 1:, :] - depth[:, :-1, :]).abs()
    gx = F.pad(gx, (0, 1), mode='replicate')
    gy = F.pad(gy[:, None], (0, 0, 0, 1), mode='replicate')[:, 0]
    grad_mag = torch.sqrt(gx ** 2 + gy ** 2 + 1e-8)
    edge_mask = (grad_mag > grad_mag.mean()).to(depth.dtype) * 0.3
    return torch.clamp(fog_density - edge_mask, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class FogDensityAwareLoss:
    base_loss: str = 'cross_entropy'
    depth_weight: float = 0.5
    fog_sensitivity: float = 2.0
    depth_loss_weight: float = 0.1

    def __call__(self, predictions: dict[str, torch.Tensor],
                 targets: dict[str, torch.Tensor],
                 fog_density: torch.Tensor | None = None,
                 sample_mask: torch.Tensor | None = None
                 ) -> dict[str, torch.Tensor]:
        """``sample_mask`` ([B] 0/1) drops padded rows from every mean."""
        seg_pred, seg_target = predictions['segmentation'], targets['label']
        if self.base_loss == 'focal':
            seg_loss = _focal_loss(seg_pred, seg_target)
        else:
            seg_loss = _per_pixel_ce(seg_pred, seg_target)
        if fog_density is not None:
            seg_loss = seg_loss * (1.0 + self.fog_sensitivity * fog_density)

        def masked_mean(x):
            if sample_mask is None:
                return x.mean()
            w = sample_mask.float().reshape((-1,) + (1,) * (x.ndim - 1))
            return (x * w).sum() / torch.clamp(
                w.sum() * (x.numel() / x.shape[0]), min=1.0)

        depth_loss = torch.zeros((), device=seg_loss.device)
        if 'depth' in predictions and self.depth_weight > 0:
            pred_depth = predictions['depth'][..., 0].float()
            if fog_density is None:
                fd = estimate_fog_density_from_depth(pred_depth)
                seg_loss = seg_loss * (1.0 + self.fog_sensitivity * fd)
            if 'depth' in targets:
                depth_loss = masked_mean((pred_depth - targets['depth']) ** 2)

        total_seg_loss = masked_mean(seg_loss)
        return {'total_loss': total_seg_loss
                + self.depth_loss_weight * depth_loss,
                'segmentation_loss': total_seg_loss,
                'depth_loss': depth_loss}


def cross_entropy_loss(predictions: dict[str, torch.Tensor],
                       targets: dict[str, torch.Tensor],
                       fog_density: torch.Tensor | None = None
                       ) -> dict[str, torch.Tensor]:
    """Plain mean CE (the trainer's 'cross_entropy' loss)."""
    seg_loss = _per_pixel_ce(predictions['segmentation'],
                             targets['label']).mean()
    return {'total_loss': seg_loss, 'segmentation_loss': seg_loss,
            'depth_loss': torch.zeros((), device=seg_loss.device)}
