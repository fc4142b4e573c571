"""Evaluation CLI (counterpart of ``awsegbench/cli/evaluate.py``), with the
same surface: a positional ``checkpoint`` and ``--config --output-dir
--device``.

Builds the model from the config on the device, loads the checkpoint's
state dict into it, runs the robustness sweep (``eval.evaluator``) over
the test split and writes ``evaluation_results.json`` and
``evaluation_report.md``. The model runs on the card unless ``--device
cpu`` (or ``device: cpu``) asks for the CPU; with no card and no such
request it raises.

    python -m awsegbench_torch.cli.evaluate runs/x/checkpoints/latest \
        --config configs/default.yaml --output-dir runs/x/eval

Under ``torchrun --nproc_per_node N`` each process is one rank of the data
mesh (``cuda:LOCAL_RANK`` over NCCL, or the CPU over gloo with ``--device
cpu``): every rank reads the same batches, the ``Evaluator`` splits them
(or one image's tiles, with ``evaluation.spatial_tiling``) over the ranks,
and rank 0 alone writes the report.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Any

import torch
from torch import nn

from ..data.dataset import CityscapesKITTIDataset
from ..data.pipeline import BatchIterator
from ..eval.evaluator import Evaluator, generate_evaluation_report
from ..models.factory import create_model
from ..train.checkpoints import load_checkpoint
from ..utils.config import Config, get_device_config, setup_logging
from .train import join_world, leave_world, load_cli_config

logger = logging.getLogger(__name__)


def load_model(checkpoint_path: str, config: Config,
               device: str | torch.device = 'cuda') -> nn.Module:
    """The architecture of the config, built on ``device``, with the
    checkpoint's state dict loaded (a checkpoint directory, its
    ``model.pt``, or a file holding a bare state dict)."""
    model = create_model(config, device=device)
    tree, _meta = load_checkpoint(checkpoint_path, map_location=device)
    model.load_state_dict(tree['state_dict'])
    logger.info(f"Loaded model from {checkpoint_path}")
    return model


def create_test_dataset_and_loader(config: Config) -> BatchIterator:
    """The test split's loader."""
    data_cfg = config.get('data', {}) or {}
    test_ds = CityscapesKITTIDataset(
        data_root=data_cfg.get('data_root', 'data'),
        split='test',
        image_size=tuple(data_cfg.get('image_size', [512, 1024])),
        weather_conditions=data_cfg.get('weather_conditions'),
        apply_augmentation=False,
        include_depth=data_cfg.get('include_depth', True),
        dataset_type=data_cfg.get('dataset_type', 'combined'),
        seed=config.get('seed', 42),
    )
    batch_size = config.get('training.batch_size', 2)
    return BatchIterator(test_ds, batch_size=batch_size, shuffle=False)


def main(argv=None) -> dict[str, Any]:
    """Run the CLI; returns the results (for callers in the same
    process)."""
    parser = argparse.ArgumentParser(
        description="Evaluate adverse weather semantic segmentation models")
    parser.add_argument('checkpoint', type=str,
                        help='Path to model checkpoint')
    parser.add_argument('--config', type=str, default='configs/default.yaml',
                        help='Path to configuration file')
    parser.add_argument('--output-dir', type=str, default='results',
                        help='Output directory for evaluation results')
    parser.add_argument('--device', type=str, default='auto',
                        help='Device to use (auto = cuda, cuda, cpu)')
    args = parser.parse_args(argv)

    if not Path(args.checkpoint).exists():
        logger.error(f"Checkpoint file not found: {args.checkpoint}")
        sys.exit(1)

    config = load_cli_config(args.config)
    if args.device != 'auto':
        config.set('device', args.device)

    setup_logging(config)
    device = join_world(get_device_config(config.get('device', 'auto')))
    try:
        model = load_model(args.checkpoint, config, device)
        test_loader = create_test_dataset_and_loader(config)
        evaluator = Evaluator(model, config, device=device)
        results = evaluator.run(test_loader, seed=config.get('seed', 42))
        if evaluator.mesh.rank == 0:
            generate_evaluation_report(results, Path(args.output_dir))
    finally:
        leave_world()
    logger.info("Evaluation complete. Results:")
    for k, v in results.items():
        if not k.startswith('_'):
            logger.info(f"  {k}: {v:.4f}" if isinstance(v, float)
                        else f"  {k}: {v}")
    return results


if __name__ == '__main__':
    main()
