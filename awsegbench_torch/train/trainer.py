"""The trainer (counterpart of ``awsegbench/train/trainer.py``).

``train_step`` is the body of one optimiser step; ``step.py::TrainStep``
wraps it with the batch preparation and draws. :class:`AdverseWeatherTrainer`
is the epoch loop around them, with the JAX trainer's public surface
(``train``, ``train_epoch``, ``validate_epoch``, ``save_checkpoint``,
``load_checkpoint``, ``resume_training``), history keys and TensorBoard
scalar names, and these of its behaviours:

* ``model.pretrained`` (true when absent) grafts the cached pretrained
  encoders into the model at construction (``models/pretrained.py``);
* ``epochs``, ``grad_clip`` and ``num_classes`` are read from the top level
  of the config first, then from their sections;
* ``loss.type: fog_density_aware`` gives ``FogDensityAwareLoss``, any
  other type plain cross-entropy;
* the scheduler steps once per epoch on ``val_loss``, into
  ``Optimizer.learning_rate``; ``is_best`` is decided on ``val_miou``;
* ``EarlyStopping`` snapshots the weights on the host and restores them to
  the device;
* a step's draws come from ``RngStreams.fold('weather', global_step)``, a
  validation batch's from step ``1_000_000_000 + epoch·1_000_000 + i``;
* the loss sums stay on the device and are fetched once per epoch; a
  step's losses are fetched only every ``logging.tb_interval_steps`` steps
  and only for a TensorBoard writer or a progress bar;
* data parallelism: the mesh comes from ``tpu.mesh_shape`` (one process
  per device, ``core/mesh.py``); rank 0's weights are broadcast once; a
  loader that yields the global batch (``process_count`` 1) has each batch
  padded to a multiple of the mesh's size by repeating its last row (the
  padded rows leave the loss through ``sample_mask``; BN's statistics see
  them, as in JAX) and each rank keeps its rows, while a process-sharded
  loader's batches are this rank's rows already; the epoch sums and the
  validation's confusion matrices are summed over the ranks
  (``psum_tree``) at the epoch's end; rank 0 alone writes checkpoints,
  TensorBoard and MLflow, and the others wait for it at a barrier;
* tensor parallelism: a ``tpu.mesh_shape`` of ``{'data': d, 'model':
  m}`` with ``m > 1`` runs ``d·m`` ranks; every rank builds the full
  model from the seed, world rank 0's weights are broadcast over the
  world, and the parameters that ``core.mesh.tp_param_shardings`` picks
  (``tpu.tp_min_features``, default 64, as JAX reads it) are sharded over
  the model group (``parallel/tensor.py``); batches, loss sums and
  confusion matrices go over the data axis (``mesh.data``). Checkpoints
  hold one process's full tensors and names, gathered before world rank
  0 writes them, so a checkpoint moves between meshes both ways;
  ``EarlyStopping``'s snapshot and restore keep each rank's slices, as
  JAX's ``_shard_like`` keeps the layout;
* two quirks of JAX's resume: ``train()`` loops from epoch 0 after
  ``load_checkpoint``, and ``global_step`` is not restored.

TensorBoard (``tensorboardX``), MLflow and ``tqdm`` are optional, as in
the JAX package.
"""

from __future__ import annotations

import functools
import inspect
import logging
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from .._device import const, resolve_device
from ..core.mesh import (DataMesh, create_mesh, mesh_rows,
                         pad_batch_to_multiple, shard_batch)
from ..core.precision import Policy, get_policy
from ..core.prng import RngStreams
from ..data.pipeline import prefetch_to_device, prepare_batch
from ..losses.fog_density import FogDensityAwareLoss, cross_entropy_loss
from ..metrics.iou import (confusion_matrix_per_weather_from_logits,
                           iou_from_confusion)
from ..models.factory import init_model_variables
from ..parallel.collectives import all_reduce_, data_parallel, psum_tree
from ..parallel.tensor import (average_replicated_, full_state_dict,
                               load_full_state_dict_)
from ..utils.config import check_tpu_section, get_device_config
from ..utils.profiling import ThroughputMeter, span, spanned, trace
from ..weather.corruption import WEATHER_CONDITIONS
from ..weather.corruption import draw_corruption
from .checkpoints import CheckpointManager
from .optim import Optimizer, create_optimizer, create_scheduler

logger = logging.getLogger(__name__)

ARRAY_KEYS = ('image', 'label', 'weather_id', 'sample_id')

try:
    from tensorboardX import SummaryWriter
    _TB_AVAILABLE = True
except ImportError:
    _TB_AVAILABLE = False
    SummaryWriter = None

try:
    import mlflow
    MLFLOW_AVAILABLE = True
except ImportError:
    MLFLOW_AVAILABLE = False
    mlflow = None

try:
    from tqdm import tqdm as _tqdm
except ImportError:
    _tqdm = None


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


@functools.cache
def _forward_params(cls: type) -> frozenset:
    return frozenset(inspect.signature(cls.forward).parameters)


def forward_params(model: nn.Module) -> frozenset:
    """The names of the parameters of ``model``'s forward."""
    return _forward_params(type(model))


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.Tensor], mesh: DataMesh) -> None:
    """Sums every parameter's ``.grad`` over the mesh's ranks in place, in
    one collective over a flat f32 buffer (a parameter with no gradient
    gets zeros first, as the optimiser would give it)."""
    if mesh.size <= 1:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = all_reduce_(torch.cat([g.reshape(-1).float() for g in grads]),
                       mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def train_step(model: nn.Module, optimizer: Optimizer, loss_fn: Callable,
               policy: Policy, image: torch.Tensor,
               targets: dict[str, torch.Tensor],
               fog_density: torch.Tensor | None, seed: torch.Tensor,
               aspp_mask: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               depth_seeds: dict[str, torch.Tensor] | None = None,
               mesh: DataMesh | None = None) -> dict[str, torch.Tensor]:
    """One optimiser step on a prepared batch: the train-mode forward of
    the parameters cast to the compute dtype (BN running stats updated),
    ``loss_fn(outputs, targets, fog_density)`` on f32 outputs (either loss
    of ``losses/fog_density.py``), the backward onto the f32 masters, clip
    and update. ``depth_seeds`` holds the depth heads' dropout seeds by the
    model's keyword ('segformer_depth_seed', 'deeplab_depth_seed' for the
    ensemble, 'depth_seed' for one member); the forward gets those of the
    draws its signature names (a SegFormer takes no ASPP mask). Returns
    the loss dict, detached; the gradients stay in the parameters'
    ``.grad``.

    With a ``mesh`` whose data axis is above one rank, the batch is this
    rank's rows of the global batch. The forward and the loss run under
    ``parallel.collectives.data_parallel`` over the data axis, so the loss
    is the global batch's on every rank. The gradient convention: each
    rank backprops its share ``total_loss / d`` (``d`` the data axis's
    size); the all-reduces inside the forward sum their gradients over the
    data ranks in the backward, so their parameter gradients *sum* (not
    average) to the global batch's gradient, and :func:`all_reduce_grads`
    sums them over the data group before the clip. The global-norm clip
    and AdamW then see the same gradients on every data rank. A model
    sharded over the mesh's model axis holds each sharded gradient as its
    slice; the replicated gradients and BN statistics are averaged over
    the model group (``parallel.tensor.average_replicated_``), so every
    rank steps the same replicated weights."""
    if not model.training:
        raise ValueError('train_step: the model is not in train mode')
    kwargs = {'seed': seed, 'aspp_mask': aspp_mask, 'generator': generator,
              **(depth_seeds or {})}
    takes = forward_params(model)
    data = mesh.data if mesh is not None else None
    world = data.size if data is not None else 1
    with data_parallel(data):
        with span('train.cast'):
            weights = policy.cast_to_compute(model)
        with span('train.forward'):
            outputs = functional_call(
                model, weights, (image.to(policy.compute_dtype),),
                {k: v for k, v in kwargs.items() if k in takes})
            outputs = {k: v.float() for k, v in outputs.items()}
        with span('train.loss'):
            loss = loss_fn(outputs, targets, fog_density)
        with span('train.backward'):
            optimizer.zero_grad()
            total = loss['total_loss']
            (total / world if world > 1 else total).backward()
    if mesh is not None and mesh.size > 1:
        with span('train.grad_sync'):
            if world > 1:
                all_reduce_grads(optimizer.params, data)
            average_replicated_(model, mesh)
    optimizer.step()
    return {k: v.detach() for k, v in loss.items()}


class EarlyStopping:
    """Early stopping on the validation loss, with best-weight restore."""

    def __init__(self, patience: int = 10, min_delta: float = 0.001,
                 restore_best_weights: bool = True) -> None:
        self.patience = patience
        self.min_delta = min_delta
        self.restore_best_weights = restore_best_weights
        self.best_loss = float('inf')
        self.counter = 0
        self.best_weights: Optional[Dict[str, torch.Tensor]] = None
        self.early_stop = False

    def __call__(self, val_loss: float, model: nn.Module
                 ) -> tuple[bool, nn.Module]:
        """Returns (should_stop, the model, its best weights restored in
        place when stopping). A model sharded over the model axis is
        snapshot and restored as this rank's slices."""
        if val_loss < self.best_loss - self.min_delta:
            self.best_loss = val_loss
            self.counter = 0
            if self.restore_best_weights:
                self.best_weights = {k: v.detach().to('cpu', copy=True)
                                     for k, v in model.state_dict().items()}
        else:
            self.counter += 1

        if self.counter >= self.patience:
            self.early_stop = True
            if self.restore_best_weights and self.best_weights:
                model.load_state_dict(self.best_weights)
        return self.early_stop, model


class AdverseWeatherTrainer:
    """Trainer with the JAX package's public surface: ``train()``,
    ``train_epoch()``, ``validate_epoch()``, ``save_checkpoint()``,
    ``load_checkpoint()``, ``resume_training()``.

    ``config`` is the repository's config as a dict. The model is trained
    on ``device`` (default: the config's ``device``, where ``'auto'`` means
    the card and raises without one) with f32 masters and the compute
    dtype of ``tpu.precision``. A loader is any iterable of batch dicts
    (``image`` [B, H, W, 3] uint8, ``label``, ``weather_id``, as numpy
    arrays or tensors), such as ``data.pipeline.BatchIterator``."""

    def __init__(self, model: nn.Module, train_loader, val_loader,
                 config: Dict[str, Any],
                 device: Optional[str | torch.device] = None,
                 checkpoint_dir: str = 'checkpoints',
                 log_dir: str = 'logs', seed: Optional[int] = None,
                 mesh: Optional[DataMesh] = None) -> None:
        from .step import TrainStep     # step.py builds on train_step above
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.config = config

        def _cfg(key, default):
            # top level first (the reference's quirk), then the section
            if key in config:
                return config[key]
            return (config.get('training') or {}).get(key, default)

        self.epochs = _cfg('epochs', 100)
        self.grad_clip = _cfg('grad_clip', 1.0)
        self.num_classes = config.get(
            'num_classes', (config.get('model') or {}).get('num_classes', 19))
        self.include_depth = (config.get('model') or {}).get('include_depth',
                                                             True)
        self.apply_augmentation = (config.get('data') or {}).get(
            'apply_augmentation', True)

        self.checkpoint_dir = Path(checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)

        check_tpu_section(config)
        self.mesh = mesh if mesh is not None else create_mesh(
            mesh_shape=(config.get('tpu') or {}).get('mesh_shape', 'auto'))
        self.is_main = self.mesh.rank == 0      # world rank 0
        self.device = resolve_device(
            device if device is not None
            else get_device_config(config.get('device', 'auto')))
        precision = (config.get('tpu') or {}).get('precision', 'bf16')
        self.policy = get_policy(precision)
        self.rngs = RngStreams(seed if seed is not None
                               else config.get('seed', 42))

        self.model = model.to(device=self.device, dtype=torch.float32)
        # pretrained encoders, where the JAX trainer grafts them (its state's
        # init_model_variables): on by default, random init where no
        # weights are cached
        init_model_variables(self.model, config)
        opt_cfg = config.get('optimizer') or {}
        self.optimizer = create_optimizer(self.model.parameters(), opt_cfg,
                                          grad_clip=self.grad_clip)
        self.base_lr = opt_cfg.get('learning_rate', 0.001)
        self.scheduler = create_scheduler(config.get('scheduler') or {},
                                          self.base_lr, self.epochs)
        self.loss_fn = self._setup_loss_function()
        self._train_step = TrainStep(
            self.model, self.optimizer, precision, self.device,
            loss_fn=self.loss_fn, apply_augmentation=self.apply_augmentation,
            mesh=self.mesh, tp_min_features=(config.get('tpu') or {}).get(
                'tp_min_features', 64))

        self.writer = (SummaryWriter(log_dir=str(self.log_dir))
                       if _TB_AVAILABLE and self.is_main else None)
        self.ckpt = CheckpointManager(str(self.checkpoint_dir))

        self.current_epoch = 0
        self.global_step = 0
        self.step_count = 0        # optimiser steps of these weights
        self.best_val_loss = float('inf')
        self.best_val_miou = 0.0

        es_cfg = config.get('early_stopping') or {}
        self.early_stopping = EarlyStopping(
            patience=es_cfg.get('patience', 10),
            min_delta=es_cfg.get('min_delta', 0.001),
            restore_best_weights=es_cfg.get('restore_best_weights', True))
        self._setup_mlflow()
        logger.info(f"Initialized AdverseWeatherTrainer with "
                    f"{type(model).__name__} on {self.device}, rank "
                    f"{self.mesh.rank} of {self.mesh.size}")

    # ------------------------------------------------------------------ setup

    def _setup_loss_function(self) -> Callable:
        loss_cfg = self.config.get('loss') or {}
        if loss_cfg.get('type', 'fog_density_aware') == 'fog_density_aware':
            return FogDensityAwareLoss(
                base_loss=loss_cfg.get('base_loss', 'cross_entropy'),
                depth_weight=loss_cfg.get('depth_weight', 0.5),
                fog_sensitivity=loss_cfg.get('fog_sensitivity', 2.0),
                depth_loss_weight=loss_cfg.get('depth_loss_weight', 0.1))
        return cross_entropy_loss

    def _setup_mlflow(self) -> None:
        if not self.is_main:
            return
        if not MLFLOW_AVAILABLE:
            logger.warning("MLflow not available. Skipping MLflow setup.")
            return
        try:
            mlflow_cfg = self.config.get('mlflow') or {}
            if mlflow_cfg.get('enabled', True):
                mlflow.set_experiment(mlflow_cfg.get(
                    'experiment_name', 'adverse_weather_segmentation'))
                mlflow.start_run(run_name=mlflow_cfg.get('run_name'))
                opt_cfg = self.config.get('optimizer') or {}
                mlflow.log_params({
                    'model_type': type(self.model).__name__,
                    'optimizer': opt_cfg.get('type', 'adamw'),
                    'learning_rate': opt_cfg.get('learning_rate', 0.001),
                    'batch_size': self.config.get('batch_size', 8),
                    'epochs': self.epochs,
                    'num_classes': self.num_classes,
                })
                logger.info("MLflow tracking initialized")
        except Exception as e:
            logger.warning(f"Failed to setup MLflow: {e}")

    # ------------------------------------------------------------- host utils

    def _rows(self, loader):
        """This rank's rows of each of the loader's batches, with their
        sample masks under ``'sample_mask'``. On a mesh above one rank a
        global batch is padded to a multiple of the mesh's size first (the
        JAX trainer's ``_pad_batch``) and cut to this rank's rows (numpy); a
        process-sharded loader's batch is this rank's rows already."""
        data = self.mesh.data
        split = data.size > 1 and getattr(loader, 'process_count', 1) == 1
        for batch in loader:
            n = len(batch['image'])
            mask = np.ones(n, np.float32)
            if split:
                arrays = {k: np.asarray(batch[k]) for k in ARRAY_KEYS
                          if k in batch}
                (arrays, mask), _ = pad_batch_to_multiple((arrays, mask),
                                                          data.size)
                mask[n:] = 0.0
                batch, mask = shard_batch((arrays, mask), self.mesh)
            yield dict(batch, sample_mask=mask)

    def _device_batches(self, loader):
        """This rank's rows of the loader's batches on the device
        (:meth:`_rows`), each copied while the step before it runs
        (``prefetch_to_device``), with their sample masks. One device never
        pads a batch: its mask is all ones."""
        for batch in prefetch_to_device(self._rows(loader), self.device):
            mask = batch.pop('sample_mask')
            if self.mesh.data.size == 1:
                mask = const(torch.ones, int(mask.shape[0]),
                             device=self.device)
            yield batch, mask

    def _progress(self, iterable, desc: str, total=None):
        """tqdm progress within an epoch, when ``logging.progress_bar`` is
        set (default: only on a terminal)."""
        enabled = (self.config.get('logging') or {}).get(
            'progress_bar', sys.stderr.isatty())
        if not enabled or _tqdm is None:
            return iterable, None
        bar = _tqdm(iterable, desc=desc, total=total, unit='batch',
                    leave=False)
        return bar, bar

    @staticmethod
    def _sizes(loader):
        try:
            return len(loader)
        except TypeError:
            return None

    # ------------------------------------------------------------ public API

    def train_epoch(self, draws: Optional[Sequence[Mapping]] = None
                    ) -> Dict[str, float]:
        """One training epoch. A step's draws come from its generator, or
        from ``draws``, one mapping per step (as ``TrainStep``'s)."""
        lr = (self.scheduler.current_lr if self.scheduler else self.base_lr)
        meter = ThroughputMeter()
        meter.start()
        sums = torch.zeros((4,), device=self.device)
        tb_interval = (self.config.get('logging') or {}).get(
            'tb_interval_steps', 10)
        batches, bar = self._progress(
            spanned(self._device_batches(self.train_loader), 'train.load'),
            f'Epoch {self.current_epoch + 1}/{self.epochs}',
            self._sizes(self.train_loader))
        for i, (batch, mask) in enumerate(batches):
            g = self.rngs.fold('weather', self.global_step, self.device)
            loss = self._train_step(
                batch['image'], batch['label'], batch['weather_id'],
                generator=g, draws=None if draws is None else draws[i],
                sample_mask=mask, sharded=True)
            self.step_count += 1
            n = mask.sum()
            sums += torch.stack([loss['total_loss'] * n,
                                 loss['segmentation_loss'] * n,
                                 loss['depth_loss'] * n, n])

            if self.global_step % tb_interval == 0 and (self.writer or bar):
                m = {k: float(v) for k, v in loss.items()}
                if self.writer:
                    self.writer.add_scalar('Train/Loss', m['total_loss'],
                                           self.global_step)
                    self.writer.add_scalar('Train/SegLoss',
                                           m['segmentation_loss'],
                                           self.global_step)
                    self.writer.add_scalar('Train/LR', lr, self.global_step)
                if bar:
                    bar.set_postfix(loss=f"{m['total_loss']:.4f}",
                                    lr=f'{lr:.2e}')
            meter.update(int(batch['image'].shape[0]) * self.mesh.data.size)
            self.global_step += 1
        if bar:
            bar.close()

        sums = psum_tree(sums, self.mesh.data)
        meter.stop(sync_on=sums)
        total, seg, depth, n_samples = sums.tolist()   # the one fetch
        out = {
            'train_loss': total / max(n_samples, 1),
            'train_seg_loss': seg / max(n_samples, 1),
            'train_depth_loss': depth / max(n_samples, 1),
            'train_samples': int(n_samples),
            'train_images_per_sec': meter.images_per_sec,
        }
        if self.writer:
            self.writer.add_scalar('Train/ImagesPerSec',
                                   meter.images_per_sec, self.current_epoch)
        return out

    def validate_epoch(self, draws: Optional[Sequence[Mapping]] = None
                       ) -> Dict[str, float]:
        """One validation epoch: the eval-mode forward of the weights (and
        BN statistics) cast to the compute dtype, the loss and per-weather
        confusion matrices summed on the device, one fetch at the end. A
        batch's draws ('corruption', 'fog_u') come from its generator, or
        from ``draws``, one mapping per batch."""
        dev, c, nw = self.device, self.num_classes, len(WEATHER_CONDITIONS)
        cm = torch.zeros((nw, c, c), dtype=torch.int64, device=dev)
        sums = torch.zeros((4,), device=dev)
        use_fog = isinstance(self.loss_fn, FogDensityAwareLoss)
        step_offset = 1_000_000_000 + self.current_epoch * 1_000_000
        batches, bar = self._progress(self._device_batches(self.val_loader),
                                      'Validation',
                                      self._sizes(self.val_loader))
        self.model.eval()
        try:
            with torch.no_grad(), data_parallel(self.mesh.data):
                weights = self.policy.cast_to_compute(self.model,
                                                      buffers=True)
                for i, (batch, mask) in enumerate(batches):
                    d = {} if draws is None else draws[i]
                    g = self.rngs.fold('weather', step_offset + i, dev)
                    images = batch['image'].to(dev)
                    wids = batch['weather_id'].to(dev)
                    b, h, w, _ = images.shape
                    # the global batch's draws (in the one-device order),
                    # this rank's rows of them
                    nb = b * self.mesh.data.size
                    rows = mesh_rows(self.mesh, nb)
                    corruption = ({k: v.to(dev) for k, v in
                                   d['corruption'].items()}
                                  if 'corruption' in d else draw_corruption(
                                      torch.zeros(nb, device=dev), h, w, g))
                    prep = prepare_batch(
                        images, batch['label'].to(dev), wids,
                        draws={k: v[rows] for k, v in corruption.items()},
                        include_depth=self.include_depth)
                    out = functional_call(
                        self.model, weights,
                        (prep['image'].to(self.policy.compute_dtype),))
                    out = {k: v.float() for k, v in out.items()}
                    targets = {'label': prep['label']}
                    if self.include_depth:
                        targets['depth'] = prep['depth']
                    if use_fog:
                        fog_u = d.get('fog_u')
                        fog_u = (torch.rand((nb, h, w), generator=g,
                                            device=dev)
                                 if fog_u is None else fog_u.to(dev))
                        fog = fog_density_from_weather(wids, h, w,
                                                       u=fog_u[rows])
                        loss = self.loss_fn(out, targets, fog,
                                            sample_mask=mask)
                    else:
                        loss = self.loss_fn(out, targets)
                    cm += confusion_matrix_per_weather_from_logits(
                        out['segmentation'], prep['label'], c, wids, nw,
                        sample_mask=mask)
                    n = mask.sum()
                    sums += torch.stack([loss['total_loss'] * n,
                                         loss['segmentation_loss'] * n,
                                         loss['depth_loss'] * n, n])
        finally:
            self.model.train()
        if bar:
            bar.close()

        cm, sums = psum_tree((cm, sums), self.mesh.data)
        total, seg, depth, n_samples = sums.tolist()   # the one fetch
        cms = cm.cpu()
        out = {
            'val_loss': total / max(n_samples, 1),
            'val_seg_loss': seg / max(n_samples, 1),
            'val_depth_loss': depth / max(n_samples, 1),
            'val_samples': int(n_samples),
            'val_miou': float(iou_from_confusion(cms.sum(0))['mean_iou']),
        }
        for wid, weather in enumerate(WEATHER_CONDITIONS):
            if cms[wid].sum() > 0:
                out[f'val_miou_{weather}'] = float(
                    iou_from_confusion(cms[wid])['mean_iou'])
        return out

    def train(self) -> Dict[str, Any]:
        """The epoch loop. ``logging.profile_dir`` captures a
        ``torch.profiler`` trace of the first epoch; ``debug.nan_checks``
        turns on autograd's anomaly detection."""
        if (self.config.get('debug') or {}).get('nan_checks'):
            from ..utils.profiling import enable_nan_checks
            enable_nan_checks(True)
        profile_dir = (self.config.get('logging') or {}).get('profile_dir')

        history = {'train': [], 'val': []}
        logger.info(f"Starting training for {self.epochs} epochs")

        for epoch in range(self.epochs):
            self.current_epoch = epoch
            start_time = time.time()

            if profile_dir and epoch == 0:
                with trace(profile_dir):
                    train_metrics = self.train_epoch()
            else:
                train_metrics = self.train_epoch()
            history['train'].append(train_metrics)

            val_metrics = self.validate_epoch()
            history['val'].append(val_metrics)

            # the scheduler steps per epoch; plateau reads the val loss
            if self.scheduler is not None:
                self.optimizer.learning_rate = self.scheduler.step(
                    val_metrics['val_loss'])

            epoch_time = time.time() - start_time
            logger.info(
                f"Epoch {epoch + 1}/{self.epochs} - "
                f"Train Loss: {train_metrics['train_loss']:.4f}, "
                f"Val Loss: {val_metrics['val_loss']:.4f}, "
                f"Val mIoU: {val_metrics['val_miou']:.4f}, "
                f"Time: {epoch_time:.1f}s")

            if self.writer:
                self.writer.add_scalar('Epoch/TrainLoss',
                                       train_metrics['train_loss'], epoch)
                self.writer.add_scalar('Epoch/ValLoss',
                                       val_metrics['val_loss'], epoch)
                self.writer.add_scalar('Epoch/ValMIoU',
                                       val_metrics['val_miou'], epoch)

            if MLFLOW_AVAILABLE and self.is_main:
                try:
                    mlflow.log_metrics({
                        'train_loss': train_metrics['train_loss'],
                        'val_loss': val_metrics['val_loss'],
                        'val_miou': val_metrics['val_miou'],
                    }, step=epoch)
                except Exception as e:
                    logger.warning(f"Failed to log to MLflow: {e}")

            is_best = val_metrics['val_miou'] > self.best_val_miou
            if is_best:
                self.best_val_miou = val_metrics['val_miou']
                self.best_val_loss = val_metrics['val_loss']

            self.save_checkpoint(epoch=epoch, metrics=val_metrics,
                                 is_best=is_best)

            should_stop, self.model = self.early_stopping(
                val_metrics['val_loss'], self.model)
            if should_stop:
                logger.info(f"Early stopping triggered at epoch {epoch + 1}")
                break

        if self.writer:
            self.writer.close()
        if MLFLOW_AVAILABLE and self.is_main:
            try:
                mlflow.end_run()
            except Exception:
                pass

        logger.info("Training completed")
        return {
            'history': history,
            'best_val_miou': self.best_val_miou,
            'best_val_loss': self.best_val_loss,
            'total_epochs': self.current_epoch + 1,
        }

    # ---------------------------------------------------------- checkpoints

    def _model_tree(self) -> Dict[str, Any]:
        """The model's tree in one process's format (sharded parameters
        gathered: a collective over the model group)."""
        return {'epoch': int(self.current_epoch), 'step': int(self.step_count),
                'state_dict': full_state_dict(self.model)}

    def _opt_tree(self) -> Dict[str, Any]:
        return {'optimizer': self.optimizer.state_dict()}

    def save_checkpoint(self, epoch: int, metrics: Dict[str, float],
                        is_best: bool = False) -> None:
        """Every rank gathers the full state (sharded parameters and their
        moments); world rank 0 writes it, the other ranks wait for it."""
        sched_state = self.scheduler.state_dict() if self.scheduler else None
        model_tree, opt_tree = self._model_tree(), self._opt_tree()
        if self.is_main:
            self.ckpt.save(epoch, model_tree, opt_tree,
                           {**metrics, 'scheduler': sched_state},
                           self.config, is_best=is_best)
        if self.mesh.size > 1:
            dist.barrier(group=self.mesh.group)

    def load_checkpoint(self, checkpoint_path: str) -> None:
        """Restore the weights, BN statistics, optimiser state, epoch and
        scheduler from a checkpoint (by name or path); ``global_step``
        stays where it is, as in the JAX trainer. A sharded model takes
        this rank's slices of the checkpoint's full tensors, as the JAX
        trainer re-shards a restored state."""
        model_tree, opt_tree, meta = self.ckpt.restore(
            checkpoint_path, map_location=self.device)
        load_full_state_dict_(self.model, model_tree['state_dict'])
        self.step_count = int(model_tree['step'])
        if opt_tree is not None:
            self.optimizer.load_state_dict(opt_tree['optimizer'])
        self.current_epoch = int(model_tree['epoch'])
        if self.scheduler and meta.get('metrics', {}).get('scheduler'):
            self.scheduler.load_state_dict(meta['metrics']['scheduler'])
        logger.info(f"Loaded checkpoint from epoch {self.current_epoch + 1}")

    def resume_training(self, checkpoint_path: str) -> Dict[str, Any]:
        self.load_checkpoint(checkpoint_path)
        return self.train()
