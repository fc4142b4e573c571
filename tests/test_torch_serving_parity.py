"""The port's serving artifact against JAX's serving forward, and the
port's export CLI (``cli/export_serving.py``), on the CPU.

* JAX's ``build_serving_fn(precision='fp32')`` on a tiny
  ``EnsembleModel(num_classes=5)`` at 32×64, with seeded variables
  (``test_torch_models.random_variables``) carried to the port by
  ``convert.flax_to_torch``, against the port's loaded ``'poly'``
  artifact on the same images: segmentation and depth within 2e-3 (the
  ensemble-logit tolerance of ROADMAP.md's parity rules).
* The port's train CLI writes a checkpoint with ``--device cpu`` (the tiny
  SegFormer config of tests/test_cli.py); the export CLI turns it into an
  artifact whose ``meta.json`` has JAX's keys plus ``torch`` and
  ``artifact``, and whose outputs equal the in-process serving forward of
  the trained model within 5e-5. ``--platforms tpu`` is refused.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.models import ensemble as jensemble
from awsegbench.serving import build_serving_fn as jbuild_serving_fn
from awsegbench_torch.cli import export_serving as export_cli
from awsegbench_torch.cli import train as train_cli
from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.data import dataset as pdataset
from awsegbench_torch.models.ensemble import EnsembleModel
from awsegbench_torch.serving import (ServingModel, build_serving_fn,
                                      export_serving, save_serving_artifact)
from test_cli import _write_tiny_config
from test_torch_cli import _eight
from test_torch_models import random_variables

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HW = (32, 64)
# scripts/export_serving.py's meta.json keys
JAX_META_KEYS = {'input_shape', 'input_dtype', 'num_classes', 'precision',
                 'include_depth', 'platforms', 'model_type',
                 'segformer_variant', 'checkpoint'}


def _images(batch, seed):
    return np.random.default_rng(seed).integers(0, 255, (batch, *HW, 3),
                                                dtype=np.uint8)


def test_artifact_matches_jax_serving_fn(tmp_path):
    jmodel = jensemble.EnsembleModel(num_classes=5, include_depth=True)
    variables = random_variables(jmodel, np.zeros((1, *HW, 3), np.float32),
                                 train=False)
    model = EnsembleModel(num_classes=5, include_depth=True)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    blob = export_serving(model.eval(), HW, batch_size='poly',
                          precision='fp32', platforms=('cpu', 'cuda'))
    out = save_serving_artifact(tmp_path / 'poly', blob,
                                {'input_shape': ['poly', *HW, 3]})
    x = _images(2, seed=1)
    with jax.default_matmul_precision('float32'):
        want = jax.jit(jbuild_serving_fn(jmodel, variables,
                                         precision='fp32'))(jnp.asarray(x))
    got = ServingModel.load(out, device='cpu').predict(x)
    assert set(got) == set(want) == {'segmentation', 'depth'}
    assert np.abs(np.asarray(want['segmentation'])).max() > 0.5
    for key in ('segmentation', 'depth'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=2e-3, atol=2e-3)


def test_export_cli_on_a_train_cli_checkpoint(tmp_path, monkeypatch):
    _eight(pdataset, monkeypatch)
    cfg = tmp_path / 'cfg.yaml'
    _write_tiny_config(cfg, tmp_path)
    trainer = train_cli.main(['--config', str(cfg), '--output-dir',
                              str(tmp_path / 'run'), '--device', 'cpu'])
    ckpt = tmp_path / 'run' / 'ckpt' / 'latest'
    out = tmp_path / 'serve'
    meta = export_cli.main([str(ckpt), '--config', str(cfg), '--out',
                            str(out), '--batch-size', 'poly', '--device',
                            'cpu'])
    written = json.loads((out / 'meta.json').read_text())
    assert written == meta
    assert set(meta) == JAX_META_KEYS | {'torch', 'artifact'}
    assert meta['input_shape'] == ['poly', *HW, 3]
    assert meta['platforms'] == ['cpu'] and meta['precision'] == 'fp32'
    assert meta['artifact'] == 'model.pt2' and (out / 'model.pt2').exists()
    assert meta['torch'] == torch.__version__

    x = _images(3, seed=2)
    got = ServingModel.load(out).predict(x)
    want = build_serving_fn(trainer.model, precision='fp32')(
        torch.from_numpy(x))
    assert set(got) == set(want) == {'segmentation', 'depth'}
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=5e-5)
    with pytest.raises(ValueError, match='platforms'):
        export_cli.main([str(ckpt), '--config', str(cfg), '--out',
                         str(tmp_path / 'tpu'), '--platforms', 'tpu',
                         '--device', 'cpu'])
