"""Optimiser and LR-scheduler factories (counterpart of
``awsegbench/train/optim.py``).

The JAX package builds an optax chain ``clip_by_global_norm(grad_clip) →
{adamw | sgd | adam}``; the port wraps the torch optimiser of the same
semantics in :class:`Optimizer`, which clips first:

* adamw: ``torch.optim.AdamW``, optax's decoupled decay (applied to every
  parameter, ``p ← p − lr·(m̂/(√v̂ + ε) + wd·p)``);
* sgd: momentum with the weight decay added to the gradient
  (``optax.add_decayed_weights`` then ``optax.sgd``) = ``torch.optim.SGD``;
* adam: Adam with the decay added to the gradient = ``torch.optim.Adam``;
* the clip is ``optax.clip_by_global_norm``: below the limit the gradients
  are untouched, above it each becomes ``g / ‖g‖ · limit``
  (``torch.nn.utils.clip_grad_norm_`` scales by ``limit/(‖g‖ + 1e-6)``);
* optax updates every parameter, so a parameter the loss does not reach
  (the fused seg head's conv bias) gets a zero gradient and still decays;
  torch would skip it.

Under tensor parallelism (``parallel/tensor.py``) a parameter sharded over
the model axis holds its slice, and so do its gradient and its moments:
the optimiser steps on the slices. The global norm counts each element
once: the replicated leaves' squares on this rank, plus the shards'
squares summed over the model group. ``state_dict`` and
``load_state_dict`` speak one process's format (every moment full size).

The three epoch schedulers are pure host code, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Iterable

import torch

from ..parallel.collectives import all_reduce_
from ..parallel.tensor import (full_optimizer_state_dict,
                               load_full_optimizer_state_dict_, shard_of)


def _sum_sq(grads) -> torch.Tensor:
    return sum(torch.sum(g.float() * g.float()) for g in grads)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         shards: list[bool] | None = None,
                         model_mesh=None) -> None:
    """``optax.clip_by_global_norm`` on ``grads`` in place (no host sync).
    Where ``shards[i]`` is true, ``grads[i]`` is this rank's slice of a
    gradient sharded over ``model_mesh``: its squares are summed over the
    model group, the replicated gradients' squares counted once."""
    if not grads:
        return
    shards = shards or [False] * len(grads)
    sq = _sum_sq(g for g, s in zip(grads, shards) if not s)
    if any(shards):
        sq = sq + all_reduce_(_sum_sq(g for g, s in zip(grads, shards) if s),
                              model_mesh)
    norm = torch.sqrt(sq)
    trigger = norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, g / norm.to(g.dtype) * max_norm))


class Optimizer:
    """Global-norm clip then a torch optimiser, stepped on the parameters'
    ``.grad``; the learning rate is settable, as optax's injected one."""

    def __init__(self, inner: torch.optim.Optimizer,
                 grad_clip: float | None) -> None:
        self.inner = inner
        self.grad_clip = grad_clip

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g['params']]

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip and self.grad_clip > 0:
            shards = [shard_of(p) for p in self.params]
            mesh = next((s[1] for s in shards if s is not None), None)
            clip_by_global_norm_([p.grad for p in self.params],
                                 self.grad_clip,
                                 [s is not None for s in shards], mesh)
        self.inner.step()

    def state_dict(self) -> dict[str, Any]:
        """The torch optimiser's state dict, every moment of a sharded
        parameter gathered to full size (a collective over the model
        group)."""
        return full_optimizer_state_dict(self.inner)

    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Loads one process's state dict (a sharded parameter's moments
        take this rank's slice)."""
        load_full_optimizer_state_dict_(self.inner, state)

    @property
    def learning_rate(self) -> float:
        return get_learning_rate(self.inner)

    @learning_rate.setter
    def learning_rate(self, lr: float) -> None:
        set_learning_rate(self.inner, lr)


def set_learning_rate(optimizer: torch.optim.Optimizer,
                      lr: float) -> torch.optim.Optimizer:
    """Write ``lr`` into every parameter group of a torch optimiser;
    returns the optimiser."""
    for g in optimizer.param_groups:
        g['lr'] = lr
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    """The learning rate of a torch optimiser's first parameter group."""
    return optimizer.param_groups[0]['lr']


def create_optimizer(params: Iterable[torch.Tensor], config: dict[str, Any],
                     grad_clip: float = 1.0) -> Optimizer:
    """The optimiser of the reference's config schema (``type``,
    ``learning_rate``, ``weight_decay``, ``betas``, ``momentum``)."""
    opt_type = str(config.get('type', 'adamw')).lower()
    lr = config.get('learning_rate', 0.001)
    wd = config.get('weight_decay', 0.01)
    params = list(params)
    if opt_type == 'adamw':
        betas = tuple(config.get('betas', (0.9, 0.999)))
        inner = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                  weight_decay=wd)
    elif opt_type == 'sgd':
        inner = torch.optim.SGD(params, lr=lr,
                                momentum=config.get('momentum', 0.9),
                                weight_decay=wd)
    else:   # adam with torch's L2-style weight decay
        inner = torch.optim.Adam(params, lr=lr, eps=1e-8, weight_decay=wd)
    return Optimizer(inner, grad_clip)


class LRScheduler:
    """Base epoch scheduler with torch-like ``step()`` semantics: epoch 0
    trains at ``base_lr``; each ``step()`` advances ``last_epoch`` and
    returns the LR for the next epoch."""

    def __init__(self, base_lr: float) -> None:
        self.base_lr = base_lr
        self.last_epoch = 0
        self.current_lr = base_lr

    def step(self, metric: float | None = None) -> float:
        self.last_epoch += 1
        self.current_lr = self._compute_lr(metric)
        return self.current_lr

    def _compute_lr(self, metric: float | None) -> float:
        raise NotImplementedError

    def state_dict(self) -> dict[str, Any]:
        return {'last_epoch': self.last_epoch, 'current_lr': self.current_lr,
                'base_lr': self.base_lr}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.last_epoch = state['last_epoch']
        self.current_lr = state['current_lr']
        self.base_lr = state.get('base_lr', self.base_lr)


class CosineAnnealingLR(LRScheduler):
    """torch.optim.lr_scheduler.CosineAnnealingLR closed form."""

    def __init__(self, base_lr: float, t_max: int,
                 eta_min: float = 1e-6) -> None:
        super().__init__(base_lr)
        self.t_max = max(1, t_max)
        self.eta_min = eta_min

    def _compute_lr(self, metric=None) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.t_max)) / 2


class StepLR(LRScheduler):
    def __init__(self, base_lr: float, step_size: int = 30,
                 gamma: float = 0.1) -> None:
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def _compute_lr(self, metric=None) -> float:
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class ReduceLROnPlateau(LRScheduler):
    """torch ReduceLROnPlateau (mode='min') semantics."""

    def __init__(self, base_lr: float, patience: int = 5, factor: float = 0.5,
                 min_lr: float = 0.0) -> None:
        super().__init__(base_lr)
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.best = float('inf')
        self.num_bad_epochs = 0

    def _compute_lr(self, metric: float | None) -> float:
        if metric is None:
            return self.current_lr
        if metric < self.best:
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return max(self.current_lr * self.factor, self.min_lr)
        return self.current_lr

    def state_dict(self) -> dict[str, Any]:
        d = super().state_dict()
        d.update({'best': self.best, 'num_bad_epochs': self.num_bad_epochs})
        return d

    def load_state_dict(self, state: dict[str, Any]) -> None:
        super().load_state_dict(state)
        self.best = state.get('best', float('inf'))
        self.num_bad_epochs = state.get('num_bad_epochs', 0)


def create_scheduler(scheduler_config: dict[str, Any], base_lr: float,
                     epochs: int) -> LRScheduler | None:
    """Scheduler factory of the reference's config schema."""
    if not scheduler_config or not scheduler_config.get('enabled', False):
        return None
    stype = scheduler_config.get('type', 'cosine')
    if stype == 'cosine':
        return CosineAnnealingLR(base_lr, t_max=epochs,
                                 eta_min=scheduler_config.get('eta_min', 1e-6))
    if stype == 'step':
        return StepLR(base_lr, step_size=scheduler_config.get('step_size', 30),
                      gamma=scheduler_config.get('gamma', 0.1))
    if stype == 'plateau':
        return ReduceLROnPlateau(base_lr,
                                 patience=scheduler_config.get('patience', 5),
                                 factor=scheduler_config.get('factor', 0.5))
    return None
