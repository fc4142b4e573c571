"""The port's CLIs (``cli/train.py``, ``cli/evaluate.py``) on the CPU, and
the port's imports.

* train CLI → checkpoint → evaluate CLI with ``--device cpu`` on
  tests/test_cli.py's tiny config (SegFormer-B0 with depth heads, 5
  classes, 32×64, 8 synthetic samples): the JAX CLIs' files with their
  result keys, a checkpoint that reloads bit-equal, and no kernel launched.
* The same through ``python -m`` in subprocesses, shrunk by a
  ``CONFIG_*`` override; and without a card, with ``device: auto``, both
  CLIs raise instead of running on the CPU.
* A JAX checkpoint carried across: the full-width ensemble's variables
  saved by JAX's ``CheckpointManager``, restored by its ``load_checkpoint``
  and written as a port checkpoint (``flax_to_torch``). With
  ``weather_conditions: [clean]`` the corruption is the identity on both
  sides, so the port's evaluate CLI sees JAX's inputs: its overall mIoU,
  ECE and AUROC are held within 2e-3 of JAX's ``Evaluator`` on the same
  test set (one-device mesh, fp32).
* A subprocess imports every module of ``awsegbench_torch`` and
  ``chip_smoke.py``: neither ``jax`` nor ``awsegbench`` is loaded.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from awsegbench.core.mesh import create_mesh
from awsegbench.data import dataset as jdataset
from awsegbench.data.pipeline import BatchIterator as JBatchIterator
from awsegbench.eval.evaluator import Evaluator as JEvaluator
from awsegbench.models import ensemble as jensemble
from awsegbench.train.checkpoints import CheckpointManager as JManager
from awsegbench.train.checkpoints import load_checkpoint as jload
from awsegbench_torch import _build
from awsegbench_torch.cli import evaluate as eval_cli
from awsegbench_torch.cli import train as train_cli
from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.data import dataset as pdataset
from awsegbench_torch.train.checkpoints import CheckpointManager
from test_cli import _write_tiny_config
from test_torch_models import random_variables

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
# The JAX CLIs' result keys: training_results.json, a history entry of
# each kind, and the Evaluator's schema for three weathers without AUROC
# (a single SegFormer has no second member)
TRAINING_KEYS = {'best_val_miou', 'best_val_loss', 'total_epochs', 'history',
                 'config'}
TRAIN_KEYS = {'train_loss', 'train_seg_loss', 'train_depth_loss',
              'train_samples', 'train_images_per_sec'}
VAL_KEYS = {'val_loss', 'val_seg_loss', 'val_depth_loss', 'val_samples',
            'val_miou'}
EVAL_KEYS = ({'overall_miou', 'expected_calibration_error',
              'robustness_degradation_ratio', '_throughput_images_per_sec',
              '_eval_seconds', '_num_images'}
             | {f'{k}_{w}' for k in ('miou', 'ece')
                for w in ('clean', 'fog', 'rain')}
             | {f'robustness_degradation_{w}' for w in ('fog', 'rain')})


def _eight(mod, monkeypatch):
    """Shrink a dataset module's synthetic set to 8 samples."""
    orig = mod.CityscapesKITTIDataset._generate_synthetic_samples
    monkeypatch.setattr(mod.CityscapesKITTIDataset,
                        '_generate_synthetic_samples',
                        lambda self: orig(self)[:8])


def test_train_then_evaluate_cli(tmp_path, monkeypatch):
    _eight(pdataset, monkeypatch)
    cfg = tmp_path / 'cfg.yaml'
    _write_tiny_config(cfg, tmp_path)
    out = tmp_path / 'run'
    _build.launches.clear()
    trainer = train_cli.main(['--config', str(cfg), '--output-dir', str(out),
                              '--device', 'cpu'])
    ckpt = out / 'ckpt' / 'latest'
    assert (ckpt / 'model.pt').exists() and (ckpt / 'opt.pt').exists()
    assert (out / 'ckpt' / 'latest.meta.json').exists()
    assert (out / 'logs').is_dir()
    tr = json.loads((out / 'results' / 'training_results.json').read_text())
    assert set(tr) == TRAINING_KEYS and tr['total_epochs'] == 1
    assert set(tr['history']['train'][0]) == TRAIN_KEYS
    assert VAL_KEYS <= set(tr['history']['val'][0])
    assert tr['history']['train'][0]['train_samples'] == 8   # 2 steps of 4
    assert tr['history']['val'][0]['val_samples'] == 8
    assert tr['config']['device'] == 'cpu'
    saved = torch.load(ckpt / 'model.pt', weights_only=True)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(saved['state_dict'][k], v), k

    res = eval_cli.main([str(ckpt), '--config', str(cfg), '--output-dir',
                         str(tmp_path / 'eval'), '--device', 'cpu'])
    written = json.loads((tmp_path / 'eval' / 'evaluation_results.json')
                         .read_text())
    assert set(written) == set(res) == EVAL_KEYS
    assert written['_num_images'] == 8
    assert all(np.isfinite(v) for v in written.values())
    assert '| miou_clean |' in (tmp_path / 'eval'
                                / 'evaluation_report.md').read_text()
    assert not _build.launches


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, '-m', *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, 'PYTHONPATH': str(ROOT),
                               **(env or {})})


def test_python_m_clis(tmp_path):
    """``python -m`` runs both CLIs on the CPU (the tiny config, batches of
    50 by an environment override: 2 train steps, one val and one test
    batch)."""
    cfg = tmp_path / 'cfg.yaml'
    _write_tiny_config(cfg, tmp_path)
    env = {'CONFIG_TRAINING__BATCH_SIZE': '50', 'OMP_NUM_THREADS': '2'}
    r = _run(['awsegbench_torch.cli.train', '--config', str(cfg),
              '--output-dir', str(tmp_path / 'run'), '--device', 'cpu'],
             tmp_path, env)
    assert r.returncode == 0, r.stderr[-3000:]
    tr = json.loads((tmp_path / 'run' / 'results' / 'training_results.json')
                    .read_text())
    assert tr['config']['training']['batch_size'] == 50
    assert tr['history']['train'][0]['train_samples'] == 100
    r = _run(['awsegbench_torch.cli.evaluate',
              str(tmp_path / 'run' / 'ckpt' / 'latest'), '--config',
              str(cfg), '--output-dir', str(tmp_path / 'eval'),
              '--device', 'cpu'], tmp_path, env)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads((tmp_path / 'eval' / 'evaluation_results.json')
                     .read_text())
    assert res['_num_images'] == 20
    assert (tmp_path / 'eval' / 'evaluation_report.md').exists()


def test_clis_raise_without_a_card(tmp_path, monkeypatch):
    """With ``device: auto`` (here an override of the config's 'cpu') and
    no card, both CLIs raise before any work; they never fall back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: auto resolves to it')
    cfg = tmp_path / 'cfg.yaml'
    _write_tiny_config(cfg, tmp_path)
    monkeypatch.setenv('CONFIG_DEVICE', 'auto')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_cli.main(['--config', str(cfg), '--output-dir',
                        str(tmp_path / 'run')])
    assert not (tmp_path / 'run' / 'results').exists()
    (tmp_path / 'ckpt').mkdir()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        eval_cli.main([str(tmp_path / 'ckpt'), '--config', str(cfg),
                       '--output-dir', str(tmp_path / 'eval')])
    assert not (tmp_path / 'eval').exists()


ENSEMBLE_CONFIG = {
    'model': {'type': 'ensemble', 'num_classes': 5, 'include_depth': True,
              'head_mode': 'faithful', 'pretrained': False},
    'data': {'dataset_type': 'synthetic', 'image_size': [32, 64],
             'weather_conditions': ['clean'], 'include_depth': True},
    'training': {'batch_size': 4},
    'evaluation': {'auroc_mode': 'histogram'},
    'logging': {'level': 'WARNING'},
    'device': 'cpu', 'seed': 42,
    'tpu': {'precision': 'fp32'},
}


def test_jax_checkpoint_through_port_evaluate_cli(tmp_path, monkeypatch):
    for mod in (pdataset, jdataset):
        _eight(mod, monkeypatch)
    config = dict(ENSEMBLE_CONFIG,
                  data=dict(ENSEMBLE_CONFIG['data'],
                            data_root=str(tmp_path / 'no_data')))
    cfg = tmp_path / 'cfg.yaml'
    cfg.write_text(yaml.safe_dump(config))
    jmodel = jensemble.EnsembleModel(num_classes=5, include_depth=True,
                                     head_mode='faithful')
    variables = random_variables(jmodel, np.zeros((1, 32, 64, 3),
                                                  np.float32), train=False)
    tree = {'epoch': np.asarray(0), 'step': np.asarray(0),
            'params': variables['params'],
            'batch_stats': variables['batch_stats']}
    JManager(str(tmp_path / 'jax')).save(0, tree, None, {'val_miou': 0.0},
                                         config, is_best=False)
    restored, _ = jload(str(tmp_path / 'jax' / 'latest'), tree)
    jvars = {'params': restored['params'],
             'batch_stats': restored['batch_stats']}
    CheckpointManager(str(tmp_path / 'port')).save(
        0, {'epoch': 0, 'step': 0,
            'state_dict': flax_to_torch(jax.device_get(jvars))},
        None, {'val_miou': 0.0}, config)

    res = eval_cli.main([str(tmp_path / 'port' / 'latest'), '--config',
                         str(cfg), '--output-dir', str(tmp_path / 'eval')])
    test_ds = jdataset.CityscapesKITTIDataset(
        data_root=str(tmp_path / 'no_data'), split='test',
        image_size=(32, 64), weather_conditions=['clean'],
        apply_augmentation=False, dataset_type='synthetic', seed=42)
    ev = JEvaluator(jmodel, jvars, config,
                    mesh=create_mesh(devices=jax.devices()[:1]))
    with jax.default_matmul_precision('float32'):
        jres = ev.run(JBatchIterator(test_ds, batch_size=4, shuffle=False),
                      seed=42)
    assert res.keys() == jres.keys()
    assert res['_num_images'] == jres['_num_images'] == 8
    for k in ('overall_miou', 'miou_clean', 'expected_calibration_error',
              'ece_clean', 'ensemble_disagreement_auroc'):
        assert abs(res[k] - jres[k]) <= 2e-3, (k, res[k], jres[k])


def test_port_imports_neither_jax_nor_the_jax_package():
    code = '''
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import awsegbench_torch
names = [m.name for m in pkgutil.walk_packages(awsegbench_torch.__path__,
                                               'awsegbench_torch.')]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location('chip_smoke', {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'orbax',
                                    'optax', 'awsegbench'))
print(len(names), bad)
assert not bad, bad
assert len(names) > 40, names
'''.format(root=str(ROOT), smoke=str(ROOT / 'chip_smoke.py'))
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT,
                       env={k: v for k, v in os.environ.items()
                            if k != 'PYTHONPATH'})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[-1] == '[]'
