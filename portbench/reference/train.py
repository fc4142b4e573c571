"""One train step of the plain reference: the batch prepared as the port's
``TrainStep`` prepares it (corruption → depth target → flip and
brightness/contrast → normalisation), the per-pixel fog density from the
weather ids, the train-mode forward in f32, the fog-density-aware loss
with its depth term (a frozen copy of
``awsegbench_torch/losses/fog_density.py`` on one device), the backward,
the global-norm clip and AdamW, all written out in plain torch."""

from __future__ import annotations

import contextlib
from typing import Mapping

import torch

from .data import prepare_batch

BASE_LOSS_FOG_SENSITIVITY, DEPTH_LOSS_WEIGHT = 2.0, 0.1


def fog_density_from_weather(weather_ids: torch.Tensor,
                             u: torch.Tensor) -> torch.Tensor:
    """fog → U[.5, 1], rain and snow → U[.2, .5], else U[0, .1], from the
    uniform ``u`` [B, H, W]."""
    wid = weather_ids[:, None, None]
    return torch.where(wid == 1, u * 0.5 + 0.5,
                       torch.where((wid == 2) | (wid == 3), u * 0.3 + 0.2,
                                   u * 0.1))


def per_pixel_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Cross entropy per pixel of NHWC logits; 0 off [0, C)."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    inside = (targets >= 0) & (targets < c)
    nll = -logp.gather(-1, targets.clamp(0, c - 1).long()[..., None])[..., 0]
    return torch.where(inside, nll, 0.0)


def fog_aware_loss(outputs: Mapping[str, torch.Tensor],
                   label: torch.Tensor, depth: torch.Tensor,
                   fog: torch.Tensor) -> dict[str, torch.Tensor]:
    """(1 + 2·fog)·CE averaged, plus 0.1 × the depth MSE."""
    seg = per_pixel_ce(outputs['segmentation'], label) * (
        1.0 + BASE_LOSS_FOG_SENSITIVITY * fog)
    depth_loss = ((outputs['depth'][..., 0].float() - depth) ** 2).mean()
    seg_loss = seg.mean()
    return {'total_loss': seg_loss + DEPTH_LOSS_WEIGHT * depth_loss,
            'segmentation_loss': seg_loss, 'depth_loss': depth_loss}


class AdamW:
    """Global-norm clip, then ``torch.optim.AdamW``'s update written out:
    decay ``p ← p·(1 − lr·wd)``, moments, bias corrections, ``p ← p −
    lr·m̂/(√v̂ + eps)``."""

    def __init__(self, params: list[torch.Tensor], lr: float, wd: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 clip: float = 1.0) -> None:
        self.params, self.lr, self.wd = params, lr, wd
        self.b1, self.b2 = betas
        self.eps, self.clip, self.t = eps, clip, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.first_grads: list[torch.Tensor] | None = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        if norm >= self.clip:
            grads = [g * (self.clip / norm).to(g.dtype) for g in grads]
        if self.first_grads is None:
            self.first_grads = [g.clone() for g in grads]
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, (v / bc2).sqrt().add_(self.eps),
                       value=-self.lr / bc1)


def step(model: torch.nn.Module, opt: AdamW, images_u8: torch.Tensor,
         labels: torch.Tensor, weather_ids: torch.Tensor, draws: Mapping,
         compute=contextlib.nullcontext) -> dict[str, float]:
    """One step on a uint8 batch with all of its draws given; the forward,
    the loss and the backward run inside ``compute()`` (the control's
    precision), the update outside it."""
    prep = prepare_batch(images_u8, labels, weather_ids, draws['corruption'],
                         include_depth=True, aug_draws=draws['augment'])
    fog = fog_density_from_weather(weather_ids, draws['fog_u'])
    for p in opt.params:
        p.grad = None
    with compute():
        out = model(prep['image'], seed=draws['seed'],
                    aspp_mask=draws['aspp_mask'],
                    segformer_depth_seed=draws['segformer_depth_seed'],
                    deeplab_depth_seed=draws['deeplab_depth_seed'])
        loss = fog_aware_loss({k: v.float() for k, v in out.items()},
                              prep['label'], prep['depth'], fog)
        loss['total_loss'].backward()
    opt.step()
    return {k: float(v.detach()) for k, v in loss.items()}

