"""The benchmark's train step (counterpart of ``bench.py``'s
``build_train`` step, as ``eval/step.py::EvalStep`` is of its eval step).

uint8 batch → ``prepare_batch(train=True)`` (mixed-weather corruption,
with depth heads the depth target estimated before the flip, flip and
brightness/contrast, ImageNet normalisation) → per-pixel fog density →
train-mode forward in the compute dtype (bf16 by default) →
fog-density-aware loss (with depth heads, plus its depth MSE) → backward →
global-norm clip → AdamW. Everything stays on the device; nothing syncs
with the host.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch import nn

from .._device import resolve_device
from ..core.mesh import (Mesh, create_mesh, has_model_axis, mesh_rows,
                         replicate, tp_param_shardings)
from ..core.precision import get_policy
from ..data.pipeline import draw_augment, prepare_batch
from ..losses.fog_density import FogDensityAwareLoss
from ..parallel.tensor import is_sharded, shard_model_
from ..weather.corruption import draw_corruption
from .optim import Optimizer, create_optimizer
from .trainer import (draw_dropout_seed, fog_density_from_weather,
                      forward_params, train_step)

# bench.py's optimiser: optax.chain(clip_by_global_norm(1.0), adamw(1e-3)),
# whose default weight decay is 1e-4
BENCH_OPTIMIZER = {'type': 'adamw', 'learning_rate': 1e-3,
                   'weight_decay': 1e-4}


DEPTH_SEEDS = ('segformer_depth_seed', 'deeplab_depth_seed', 'depth_seed')


class TrainStep:
    """Puts ``model`` on ``device`` with f32 parameters in train mode and
    steps it with ``loss_fn`` (default ``FogDensityAwareLoss()``).
    ``optimizer`` defaults to bench.py's (clip 1.0, AdamW lr 1e-3, decay
    1e-4), ``precision`` to bf16 compute. A model with depth heads
    (``include_depth=True``, bench.py's configuration) also learns from the
    estimated depth of the corrupted images through the loss's depth term.
    ``apply_augmentation=False`` leaves out the flip and
    brightness/contrast. With any loss but ``FogDensityAwareLoss`` no fog
    density is drawn, as the JAX trainer's plain cross-entropy takes
    none.

    Data parallelism: ``mesh`` (default ``core.mesh.create_mesh()``, the
    world of the process group, or this process alone) spreads each step
    over its ranks, one process per device. Rank 0's parameters and BN
    statistics are broadcast to the others once, here. A step then takes
    the same global batch and draws as on one device: each rank keeps its
    rows, BN's statistics and the loss's means are the global batch's,
    and the gradients are summed over the ranks before the clip
    (``trainer.train_step``).

    Tensor parallelism: on a mesh with a model axis above 1
    (``core.mesh.TPMesh``), after that broadcast over the world, the
    parameters that ``core.mesh.tp_param_shardings`` picks at
    ``tp_min_features`` are sharded over the model group in place
    (``parallel.tensor.shard_model_``; an ``optimizer`` built before on
    the model's parameters keeps them). A model sharded already is taken
    as it is. The batch and the draws go over the data axis only: the
    ranks of one model group take the same rows."""

    def __init__(self, model: nn.Module, optimizer: Optimizer | None = None,
                 precision: str = 'bf16',
                 device: str | torch.device = 'cuda',
                 loss_fn: Callable | None = None,
                 apply_augmentation: bool = True,
                 mesh: Mesh | None = None,
                 tp_min_features: int = 64) -> None:
        self.device = resolve_device(device)
        self.policy = get_policy(precision)
        self.model = model.to(device=self.device,
                              dtype=self.policy.param_dtype).train()
        self.mesh = mesh if mesh is not None else create_mesh()
        if not is_sharded(self.model):
            replicate(self.model, self.mesh)
            if has_model_axis(self.mesh):
                shard_model_(self.model, self.mesh, tp_param_shardings(
                    self.model, self.mesh, tp_min_features))
        self.include_depth = getattr(model, 'include_depth', False)
        self.apply_augmentation = apply_augmentation
        self.optimizer = optimizer or create_optimizer(
            self.model.parameters(), BENCH_OPTIMIZER, grad_clip=1.0)
        self.loss_fn = loss_fn or FogDensityAwareLoss()
        self.use_fog = isinstance(self.loss_fn, FogDensityAwareLoss)
        takes = forward_params(self.model)
        self.seed_names = tuple(
            k for k in ('seed',) + (DEPTH_SEEDS if self.include_depth else ())
            if k in takes)

    def _local(self, images_u8, labels, weather_ids, sample_mask):
        """This rank's rows of a global batch, padded first to a multiple
        of the mesh by repeating its last row (the padded rows leave the
        loss through ``sample_mask``, as in the JAX trainer); returns them,
        their mask and the padded global batch's size."""
        n = self.mesh.data.size
        b = images_u8.shape[0]
        pad = (-b) % n
        if pad:
            def edge(t):
                return torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])
            images_u8, labels, weather_ids = (
                edge(t) for t in (images_u8, labels, weather_ids))
            keep = (torch.ones(b, device=self.device) if sample_mask is None
                    else sample_mask.to(self.device).float())
            sample_mask = torch.cat([keep, keep.new_zeros(pad)])
        rows = mesh_rows(self.mesh, b + pad)
        if sample_mask is not None:
            sample_mask = sample_mask[rows]
        return (images_u8[rows], labels[rows], weather_ids[rows],
                sample_mask, b + pad)

    def __call__(self, images_u8: torch.Tensor, labels: torch.Tensor,
                 weather_ids: torch.Tensor,
                 generator: torch.Generator | None = None,
                 draws: dict | None = None,
                 sample_mask: torch.Tensor | None = None,
                 sharded: bool = False) -> dict[str, torch.Tensor]:
        """One step on images [B, H, W, 3] uint8, labels [B, H, W] and
        weather ids [B]: the global batch, or with ``sharded`` this rank's
        rows of it (a process-sharded loader's; every rank holds as many).
        Every random draw is the global batch's, from ``generator`` (on the
        device, seeded alike on every rank) unless given in ``draws``:
        'corruption' (as ``draw_corruption``), 'augment' (as
        ``draw_augment``), 'fog_u' [B, H, W], 'seed' (int32, the seg head's
        dropout), 'aspp_mask' [B, h/16, w/16, 256] bool and, with depth
        heads, one int32 seed per depth head under the model's keyword
        ('segformer_depth_seed' and 'deeplab_depth_seed' for the ensemble,
        'depth_seed' for one member); the per-row draws hold the padded
        global batch's rows. ``sample_mask`` ([B] 0/1) drops rows from the
        fog-density-aware loss's means. Returns the loss dict: the global
        batch's losses, on every rank."""
        dev = self.device
        draws = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                     if isinstance(v, dict) else v.to(dev))
                 for k, v in (draws or {}).items()}
        images_u8, labels = images_u8.to(dev), labels.to(dev)
        weather_ids = weather_ids.to(dev)
        if sharded:
            nb = images_u8.shape[0] * self.mesh.data.size
        else:
            images_u8, labels, weather_ids, sample_mask, nb = self._local(
                images_u8, labels, weather_ids, sample_mask)
        rows = mesh_rows(self.mesh, nb)
        _, h, w, _ = images_u8.shape

        def drawn(name, draw):
            """The global batch's draw ``name`` (given, or drawn now, in
            the one-device step's order), this rank's rows of it."""
            d = draws.get(name)
            if d is None:
                if generator is None and name != 'fog_u':
                    raise ValueError('prepare_batch needs a generator or '
                                     'draws')
                d = draw()
            if isinstance(d, dict):
                return {k: v[rows] for k, v in d.items()}
            return d[rows]

        corruption = drawn('corruption', lambda: draw_corruption(
            torch.zeros(nb, device=dev), h, w, generator))
        augment = (drawn('augment', lambda: draw_augment(nb, generator, dev))
                   if self.apply_augmentation else None)
        prep = prepare_batch(images_u8, labels, weather_ids,
                             draws=corruption,
                             include_depth=self.include_depth, train=True,
                             apply_augmentation=self.apply_augmentation,
                             aug_draws=augment)
        loss_fn, fog = self.loss_fn, None
        if self.use_fog:
            fog = fog_density_from_weather(weather_ids, h, w, u=drawn(
                'fog_u', lambda: torch.rand((nb, h, w), generator=generator,
                                            device=dev)))
            loss_fn = functools.partial(loss_fn, sample_mask=sample_mask)
        seeds = {k: draws[k] if k in draws else draw_dropout_seed(generator,
                                                                  dev)
                 for k in self.seed_names}
        aspp_mask = draws.get('aspp_mask')
        targets = {'label': prep['label']}
        if self.include_depth:
            targets['depth'] = prep['depth']
        return train_step(self.model, self.optimizer, loss_fn,
                          self.policy, prep['image'], targets, fog,
                          seeds.pop('seed', None),
                          None if aspp_mask is None else aspp_mask[rows],
                          generator, seeds, mesh=self.mesh)

