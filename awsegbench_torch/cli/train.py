"""Training CLI (counterpart of ``awsegbench/cli/train.py``), with the
same flags: ``--config --resume --device --seed --output-dir``.

A missing or unreadable config falls back to the default config; the
results go to ``<output>/<paths.results>/training_results.json`` and the
checkpoints to ``<output>/<paths.checkpoints>/``. The model trains on the
card unless ``--device cpu`` (or ``device: cpu``) asks for the CPU; with
no card and no such request it raises.

    python -m awsegbench_torch.cli.train --config configs/default.yaml \
        --output-dir runs/x

Under ``torchrun --nproc_per_node N`` each process is one rank of the
mesh of ``tpu.mesh_shape`` (``core/mesh.py``): rank r takes
``cuda:LOCAL_RANK`` over NCCL, or the CPU over gloo with ``--device
cpu``; the train loader gives each rank its rows of every global batch
over the data axis, and world rank 0 alone writes the checkpoints and
results. With ``tpu.mesh_shape: {data: d, model: m}`` (``N = d·m``) the
model's wide parameters are sharded over the ``m`` ranks of each model
group (tensor parallelism, ``parallel/tensor.py``).

    torchrun --nproc_per_node 2 -m awsegbench_torch.cli.train \
        --config configs/default.yaml --output-dir runs/x --device cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import sys
from pathlib import Path

import numpy as np
import torch.distributed as dist

from ..core.mesh import Mesh, create_mesh, init_distributed
from ..data.dataset import CityscapesKITTIDataset
from ..data.pipeline import BatchIterator
from ..models.factory import count_parameters, create_model
from ..train.trainer import AdverseWeatherTrainer
from ..utils.config import (Config, create_default_config, get_device_config,
                            load_config, setup_logging, validate_config)

logger = logging.getLogger(__name__)


def set_seed(seed: int) -> None:
    """Seed the host RNGs; the device's draws come from ``RngStreams`` of
    the same seed inside the trainer."""
    random.seed(seed)
    np.random.seed(seed)


def load_cli_config(path: str) -> Config:
    """The YAML config at ``path`` (with its environment overrides), or the
    default config when it is missing or cannot be read."""
    try:
        if Path(path).exists():
            return load_config(path)
        logger.warning(f"Config file {path} not found. "
                       "Using default configuration.")
    except Exception as e:
        logger.error(f"Error loading config: {e}")
        logger.info("Using default configuration")
    return create_default_config()


def join_world(device: str) -> str:
    """Under torchrun (``WORLD_SIZE`` above 1) joins the process group,
    over gloo on the CPU and NCCL on cards, and returns this rank's device
    (``cuda:LOCAL_RANK``); else ``device``."""
    if not init_distributed(backend='gloo' if device == 'cpu' else None):
        return device
    if device == 'cpu':
        return device
    return f"cuda:{int(os.environ.get('LOCAL_RANK', dist.get_rank()))}"


def leave_world() -> None:
    """Leaves the process group, if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def create_datasets_and_loaders(config: Config, mesh: Mesh | None = None):
    """The train and val datasets and their loaders. With a ``mesh`` whose
    data axis is above one rank, the train loader gives each rank its rows
    of every global batch (when the batch divides over the data axis);
    the val loader gives every rank the global batch, which the trainer
    pads and splits."""
    data_cfg = config.get('data', {}) or {}
    common = dict(
        data_root=data_cfg.get('data_root', 'data'),
        image_size=tuple(data_cfg.get('image_size', [512, 1024])),
        weather_conditions=data_cfg.get('weather_conditions'),
        apply_augmentation=data_cfg.get('apply_augmentation', True),
        include_depth=data_cfg.get('include_depth', True),
        dataset_type=data_cfg.get('dataset_type', 'combined'),
        seed=config.get('seed', 42),
        decoded_cache=data_cfg.get('decoded_cache'),
    )
    train_ds = CityscapesKITTIDataset(split='train', **common)
    val_ds = CityscapesKITTIDataset(split='val', **common)

    batch_size = config.get('training.batch_size', 2)
    num_workers = config.get('training.num_workers', 4)
    data = (mesh if mesh is not None else create_mesh()).data
    process = (dict(process_index=data.rank, process_count=data.size)
               if data.size > 1 and batch_size % data.size == 0 else {})
    train_loader = BatchIterator(train_ds, batch_size=batch_size, shuffle=True,
                                 seed=config.get('seed', 42),
                                 num_threads=num_workers, **process)
    val_loader = BatchIterator(val_ds, batch_size=batch_size, shuffle=False,
                               num_threads=num_workers)
    return train_loader, val_loader


def main(argv=None) -> AdverseWeatherTrainer | None:
    """Run the CLI; returns the trainer (for callers in the same process),
    or None when training was interrupted."""
    parser = argparse.ArgumentParser(
        description="Train adverse weather semantic segmentation models")
    parser.add_argument('--config', type=str, default='configs/default.yaml',
                        help='Path to configuration file')
    parser.add_argument('--resume', type=str, default=None,
                        help='Path to checkpoint to resume from')
    parser.add_argument('--device', type=str, default='auto',
                        help='Device to use (auto = cuda, cuda, cpu)')
    parser.add_argument('--seed', type=int, default=None,
                        help='Random seed (overrides config)')
    parser.add_argument('--output-dir', type=str, default='.',
                        help='Output directory for checkpoints and logs')
    args = parser.parse_args(argv)

    config = load_cli_config(args.config)
    if args.device != 'auto':
        config.set('device', args.device)
    if args.seed is not None:
        config.set('seed', args.seed)

    output_dir = Path(args.output_dir)
    checkpoint_dir = output_dir / config.get('paths.checkpoints', 'checkpoints')
    log_dir = output_dir / config.get('paths.logs', 'logs')
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    log_dir.mkdir(parents=True, exist_ok=True)

    setup_logging(config)
    try:
        validate_config(config)
    except ValueError as e:
        logger.error(f"Configuration validation failed: {e}")
        sys.exit(1)

    seed = config.get('seed', 42)
    set_seed(seed)
    device = join_world(get_device_config(config.get('device', 'auto')))
    logger.info(f"Using device: {device}")
    try:
        return _train(args, config, device, output_dir, checkpoint_dir,
                      log_dir)
    finally:
        leave_world()


def _train(args, config: Config, device: str, output_dir: Path,
           checkpoint_dir: Path, log_dir: Path
           ) -> AdverseWeatherTrainer | None:

    try:
        model = create_model(config, device=device)
    except Exception as e:
        logger.error(f"Error creating model: {e}")
        sys.exit(1)
    mesh = create_mesh(mesh_shape=config.get('tpu.mesh_shape', 'auto'))
    # Missing dataset files are handled inside the dataset itself
    # (synthetic fallback); any exception here is a real error.
    try:
        train_loader, val_loader = create_datasets_and_loaders(config, mesh)
    except Exception as e:
        logger.error(f"Error creating datasets: {e}")
        sys.exit(1)

    trainer = AdverseWeatherTrainer(
        model=model,
        train_loader=train_loader,
        val_loader=val_loader,
        config=config.to_dict(),
        device=device,
        checkpoint_dir=str(checkpoint_dir),
        log_dir=str(log_dir),
        mesh=mesh,
    )
    logger.info(f"Model parameters: {count_parameters(model):,} total")

    if args.resume:
        try:
            trainer.load_checkpoint(args.resume)
            logger.info(f"Resumed training from {args.resume}")
        except Exception as e:
            logger.error(f"Error loading checkpoint: {e}")
            sys.exit(1)

    try:
        logger.info("Starting training...")
        results = trainer.train()
    except KeyboardInterrupt:
        logger.info("Training interrupted by user")
        return None
    except Exception as e:
        logger.error(f"Training failed: {e}")
        raise
    logger.info("Training completed successfully!")
    logger.info(f"Best validation mIoU: {results['best_val_miou']:.4f}")
    logger.info(f"Best validation loss: {results['best_val_loss']:.4f}")
    logger.info(f"Total epochs: {results['total_epochs']}")

    if not trainer.is_main:
        return trainer
    results_dir = output_dir / config.get('paths.results', 'results')
    results_dir.mkdir(parents=True, exist_ok=True)
    with open(results_dir / 'training_results.json', 'w') as f:
        json.dump({
            'best_val_miou': results['best_val_miou'],
            'best_val_loss': results['best_val_loss'],
            'total_epochs': results['total_epochs'],
            # per-epoch losses + train_images_per_sec (throughput record)
            'history': results['history'],
            'config': config.to_dict(),
        }, f, indent=2, default=str)
    return trainer


if __name__ == '__main__':
    main()
