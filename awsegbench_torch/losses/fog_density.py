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

Under a data-parallel mesh (``parallel.collectives.data_parallel``) every
mean, and the fog-from-depth heuristic's min, max and edge mean, is the
global batch's: sums and counts go through ``sync_sum``, so each rank
returns the global loss, as the JAX step over the global batch does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel.collectives import (active_mesh, all_reduce_, global_rows,
                                    sync_sum)


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


def _global_extreme(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """The global batch's min (max with ``largest``) of ``x`` over every
    rank. Its gradient splits evenly over every element, on any rank, equal
    to it, as ``Tensor.min()``'s does on one device."""
    local = (x.max() if largest else x.min()).detach().clone()
    mesh = active_mesh()
    all_reduce_(local, mesh, dist.ReduceOp.MAX if largest
                else dist.ReduceOp.MIN)
    hit = (x == local).to(x.dtype)
    share = sync_sum((x * hit).sum()) / sync_sum(hit.sum())
    return local + (share - share.detach())


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The global batch's mean of ``x`` (every rank holds as many rows)."""
    if active_mesh() is None:
        return x.mean()
    return sync_sum(x.sum()) / (global_rows(x.shape[0])
                                * (x.numel() // x.shape[0]))


def estimate_fog_density_from_depth(depth: torch.Tensor) -> torch.Tensor:
    """Fog density heuristic from predicted depth [B, H, W]: depth
    normalised over the whole batch, ×0.7, minus 0.3 where the
    forward-difference gradient magnitude (replicate-padded at the trailing
    edge) exceeds its mean, clipped to [0, 1]."""
    if active_mesh() is None:
        dmin, dmax = depth.min(), depth.max()
    else:
        dmin = _global_extreme(depth, largest=False)
        dmax = _global_extreme(depth, largest=True)
    fog_density = (depth - dmin) / (dmax - dmin + 1e-8) * 0.7
    gx = (depth[:, :, 1:] - depth[:, :, :-1]).abs()
    gy = (depth[:, 1:, :] - depth[:, :-1, :]).abs()
    gx = F.pad(gx, (0, 1), mode='replicate')
    gy = F.pad(gy[:, None], (0, 0, 0, 1), mode='replicate')[:, 0]
    grad_mag = torch.sqrt(gx ** 2 + gy ** 2 + 1e-8)
    edge_mask = (grad_mag > _mean(grad_mag)).to(depth.dtype) * 0.3
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
                return _mean(x)
            w = sample_mask.float().reshape((-1,) + (1,) * (x.ndim - 1))
            return sync_sum((x * w).sum()) / torch.clamp(
                sync_sum(w.sum()) * (x.numel() / x.shape[0]), min=1.0)

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
    seg_loss = _mean(_per_pixel_ce(predictions['segmentation'],
                                   targets['label']))
    return {'total_loss': seg_loss, 'segmentation_loss': seg_loss,
            'depth_loss': torch.zeros((), device=seg_loss.device)}
