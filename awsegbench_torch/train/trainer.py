"""The train step's body (counterpart of ``fog_density_from_weather`` and
``_build_train_step``'s ``step`` in ``awsegbench/train/trainer.py``).

The epoch loop, early stopping, checkpoints and logging of the JAX
``AdverseWeatherTrainer`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from ..core.precision import Policy
from .optim import Optimizer


def fog_density_from_weather(weather_ids: torch.Tensor, height: int,
                             width: int,
                             generator: torch.Generator | None = None,
                             u: torch.Tensor | None = None) -> torch.Tensor:
    """Random per-pixel fog density keyed on the weather id: fog →
    U[.5, 1], rain/snow → U[.2, .5], else U[0, .1], from the uniform ``u``
    [B, H, W] (drawn from ``generator`` when not given)."""
    if u is None:
        u = torch.rand((weather_ids.shape[0], height, width),
                       generator=generator, device=weather_ids.device)
    wid = weather_ids[:, None, None]
    fog, mid, low = u * 0.5 + 0.5, u * 0.3 + 0.2, u * 0.1
    return torch.where(wid == 1, fog,
                       torch.where((wid == 2) | (wid == 3), mid, low))


def draw_dropout_seed(generator: torch.Generator,
                      device: torch.device) -> torch.Tensor:
    """An int32 seed for a head's counter-hash dropout."""
    return torch.randint(-2 ** 31, 2 ** 31, (), generator=generator,
                         device=device, dtype=torch.int64).to(torch.int32)


def train_step(model: nn.Module, optimizer: Optimizer, loss_fn: Callable,
               policy: Policy, image: torch.Tensor,
               targets: dict[str, torch.Tensor],
               fog_density: torch.Tensor | None, seed: torch.Tensor,
               aspp_mask: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               depth_seeds: dict[str, torch.Tensor] | None = None
               ) -> dict[str, torch.Tensor]:
    """One optimiser step on a prepared batch: the train-mode forward of
    the parameters cast to the compute dtype (BN running stats updated),
    ``loss_fn(outputs, targets, fog_density)`` on f32 outputs (either loss
    of ``losses/fog_density.py``), the backward onto the f32 masters, clip
    and update. ``depth_seeds`` holds the depth heads' dropout seeds by the
    model's keyword ('segformer_depth_seed', 'deeplab_depth_seed'). Returns
    the loss dict, detached; the gradients stay in the parameters'
    ``.grad``."""
    if not model.training:
        raise ValueError('train_step: the model is not in train mode')
    outputs = functional_call(
        model, policy.cast_to_compute(model),
        (image.to(policy.compute_dtype),),
        {'seed': seed, 'aspp_mask': aspp_mask, 'generator': generator,
         **(depth_seeds or {})})
    outputs = {k: v.float() for k, v in outputs.items()}
    loss = loss_fn(outputs, targets, fog_density)
    optimizer.zero_grad()
    loss['total_loss'].backward()
    optimizer.step()
    return {k: v.detach() for k, v in loss.items()}
