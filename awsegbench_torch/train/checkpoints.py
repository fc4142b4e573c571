"""Checkpoints: latest / best / periodic, with ``torch.save`` (counterpart
of ``awsegbench/train/checkpoints.py``, which writes Orbax trees).

A checkpoint named ``<name>`` under ``checkpoint_dir`` is

* ``<name>/model.pt``: ``{'epoch': int, 'step': int, 'state_dict': ...}``,
  the model's state dict with its BN running statistics;
* ``<name>/opt.pt``: the optimiser's state (``{'optimizer': ...}``), so
  evaluation can restore the weights without the optimiser;
* ``<name>.meta.json``: ``{'epoch', 'metrics', 'config'}``, the metrics
  carrying the scheduler's state under ``'scheduler'``.

Names as the JAX package's: ``latest`` every epoch, ``best`` on
improvement, ``epoch_{N}`` every ``keep_every`` epochs. Files are written
under a temporary name and renamed into place, so a crash mid-write never
leaves a torn checkpoint. Loading uses ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

MODEL_FILE, OPT_FILE = 'model.pt', 'opt.pt'


def _save(obj: Any, path: Path) -> None:
    tmp = path.with_name(path.name + '.tmp')
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: Path, map_location) -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


def _read_meta(path: Path) -> Dict[str, Any]:
    meta_path = Path(str(path) + '.meta.json')
    if not meta_path.exists():
        return {}
    with open(meta_path) as f:
        return json.load(f)


class CheckpointManager:
    """latest / best / periodic checkpoints of the model and optimiser
    states."""

    def __init__(self, checkpoint_dir: str, keep_every: int = 10) -> None:
        self.checkpoint_dir = Path(checkpoint_dir).absolute()
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.keep_every = keep_every

    def _save_to(self, name: str, model_tree: Dict[str, Any],
                 opt_tree: Optional[Dict[str, Any]],
                 meta: Dict[str, Any]) -> None:
        path = self.checkpoint_dir / name
        path.mkdir(parents=True, exist_ok=True)
        _save(model_tree, path / MODEL_FILE)
        if opt_tree is not None:
            _save(opt_tree, path / OPT_FILE)
        with open(self.checkpoint_dir / f"{name}.meta.json", 'w') as f:
            json.dump(meta, f, indent=2, default=str)

    def _copy(self, src: str, dst: str) -> None:
        """``dst`` as a copy of the checkpoint just written as ``src``."""
        d = self.checkpoint_dir / dst
        d.mkdir(parents=True, exist_ok=True)
        for f in (MODEL_FILE, OPT_FILE):
            s = self.checkpoint_dir / src / f
            if s.exists():
                tmp = d / (f + '.tmp')
                shutil.copyfile(s, tmp)
                os.replace(tmp, d / f)
        shutil.copyfile(self.checkpoint_dir / f'{src}.meta.json',
                        self.checkpoint_dir / f'{dst}.meta.json')

    def save(self, epoch: int, model_tree: Dict[str, Any],
             opt_tree: Optional[Dict[str, Any]],
             metrics: Dict[str, float], config: Dict[str, Any],
             is_best: bool = False) -> None:
        """'latest' every epoch, 'best' on improvement, 'epoch_{N}' every
        ``keep_every`` epochs (the last two copied from 'latest')."""
        meta = {'epoch': epoch, 'metrics': metrics, 'config': config}
        self._save_to('latest', model_tree, opt_tree, meta)
        if is_best:
            self._copy('latest', 'best')
            logger.info(f"New best model saved with mIoU: "
                        f"{metrics.get('val_miou', float('nan')):.4f}")
        if (epoch + 1) % self.keep_every == 0:
            self._copy('latest', f'epoch_{epoch + 1}')

    def restore(self, name_or_path: str, map_location='cpu'
                ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]],
                           Dict[str, Any]]:
        """Restore by name ('latest', 'best', 'epoch_N') or path.

        Returns (model_tree, opt_tree or None, meta)."""
        path = Path(name_or_path)
        if not path.is_absolute() and not path.exists():
            path = self.checkpoint_dir / name_or_path
        path = path.absolute()
        model_tree = _load(path / MODEL_FILE, map_location)
        opt_tree = (_load(path / OPT_FILE, map_location)
                    if (path / OPT_FILE).exists() else None)
        logger.info(f"Loaded checkpoint from {path}")
        return model_tree, opt_tree, _read_meta(path)


def load_checkpoint(checkpoint_path: str, map_location='cpu'
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The model part of a checkpoint, for evaluation: a checkpoint
    directory (its ``model.pt``), a ``model.pt`` file, or a file holding a
    bare state dict (returned as ``{'state_dict': ...}``). Returns (tree,
    meta)."""
    path = Path(checkpoint_path).absolute()
    file = path / MODEL_FILE if path.is_dir() else path
    tree = _load(file, map_location)
    if 'state_dict' not in tree:
        tree = {'state_dict': tree}
    return tree, _read_meta(path)
