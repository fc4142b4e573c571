"""The port's ``Evaluator`` against the JAX package's, on the CPU.

The JAX side runs its own ``Evaluator`` on a one-device mesh with the
``fp32`` policy; the port's gets the same full-width ensemble (weights
carried across by ``convert.flax_to_torch``), the same loader (64×128, two
batches of five, every weather in each) and JAX's corruption draws (its
per-sample keys, ``per_sample_keys(RngStreams(seed).fold('weather', i),
sample_ids)``). Both run in each AUROC mode. Tolerances: the per-weather
confusion matrices within 0.1% of each weather's pixels, as
tests/test_torch_eval_step.py holds the eval step's (argmax near-ties may
flip, and XLA rounds the jitted corruption blur's last bit differently);
mIoU, ECE and AUROC within 2e-3.

The sweep's own logic (modes, the memory guard, unsized loaders, empty
sweeps, the report files) is also held on a two-member stand-in model,
whose sweep costs little.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch import nn

from awsegbench.core.mesh import create_mesh
from awsegbench.core.prng import RngStreams, per_sample_keys
from awsegbench.eval import evaluator as jevaluator
from awsegbench.models import ensemble as jensemble
from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.eval import evaluator
from awsegbench_torch.models.ensemble import EnsembleModel
from awsegbench_torch.ops import attention, headkernels, splat
from test_torch_models import random_variables
from test_torch_weather import _jax_draws

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, W, C, SEED = 5, 64, 128, 19, 3
CONFIG = {'model': {'num_classes': C}, 'tpu': {'precision': 'fp32'}}
MODES = ('histogram', 'exact', 'exact_host')


def _loader(seed=0, n=2, h=H, w=W, c=C):
    """``n`` batches of ``B`` images, every weather once in each batch,
    random labels with an ignored corner."""
    rng = np.random.default_rng(seed)
    batches = []
    for i in range(n):
        labels = rng.integers(0, c, (B, h, w)).astype(np.int32)
        labels[:, :4, :8] = 255
        batches.append({
            'image': rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8),
            'label': labels,
            'weather_id': rng.permutation(5).astype(np.int32),
            'sample_id': np.arange(i * B, (i + 1) * B, dtype=np.int32)})
    return batches


def _draws(loader, seed=SEED):
    """JAX's corruption draws for each batch of its sweep."""
    rngs = RngStreams(seed)
    return [_jax_draws(per_sample_keys(rngs.fold('weather', i),
                                       jnp.asarray(b['sample_id'])),
                       *b['image'].shape[1:3])
            for i, b in enumerate(loader)]


def _jax_run(model, variables, loader, mode, config=CONFIG, seed=SEED):
    ev = jevaluator.Evaluator(model, variables, config,
                              mesh=create_mesh(devices=jax.devices()[:1]),
                              auroc_mode=mode)
    with jax.default_matmul_precision('float32'):
        return ev, ev.run(loader, seed=seed)


def _jax_acc(ev, loader, seed=SEED):
    """The JAX sweep's accumulators (its overall slot first), from its
    own compiled step."""
    rngs, acc = RngStreams(seed), ev._init_acc(0)
    for i, b in enumerate(loader):
        with jax.default_matmul_precision('float32'):
            acc, _ = ev._step(ev.variables, b['image'], b['label'],
                              b['weather_id'], b['sample_id'],
                              np.ones(B, bool), rngs.fold('weather', i), acc)
    return {k: np.asarray(v) for k, v in acc.items()}


@pytest.fixture(scope='module')
def sweeps():
    loader = _loader()
    jmodel = jensemble.EnsembleModel(num_classes=C, include_depth=True,
                                     head_mode='faithful')
    variables = random_variables(jmodel, loader[0]['image'][:1]
                                 .astype(np.float32), train=False)
    model = EnsembleModel(num_classes=C, include_depth=True,
                          head_mode='faithful')
    model.load_state_dict(flax_to_torch(variables), strict=True)
    draws = _draws(loader)
    out = {}
    for mode in MODES:
        jev, jres = _jax_run(jmodel, variables, loader, mode)
        ev = evaluator.Evaluator(model, CONFIG, auroc_mode=mode, device='cpu')
        res = ev.run(loader, seed=SEED, draws=draws)
        out[mode] = (jev, jres, ev, res)
    return loader, out


@pytest.mark.parametrize('mode', MODES)
def test_evaluator_schema_matches_jax(sweeps, mode):
    _, out = sweeps
    _, jres, _, res = out[mode]
    assert res.keys() == jres.keys()
    assert res['_num_images'] == jres['_num_images'] == 2 * B
    for k, v in res.items():
        assert isinstance(v, (int, float)) and np.isfinite(v), (k, v)


@pytest.mark.parametrize('mode', MODES)
def test_evaluator_metrics_match_jax(sweeps, mode):
    _, out = sweeps
    _, jres, _, res = out[mode]
    for k, v in jres.items():
        if not k.startswith('_') or k == '_auroc_histogram_estimate':
            assert abs(res[k] - v) <= 2e-3, (k, res[k], v)


def test_evaluator_auroc_modes_agree(sweeps):
    _, out = sweeps
    hist = out['histogram'][3]['ensemble_disagreement_auroc']
    exact = out['exact'][3]['ensemble_disagreement_auroc']
    assert out['exact_host'][3]['ensemble_disagreement_auroc'] == exact
    for mode in ('exact', 'exact_host'):
        assert out[mode][3]['_auroc_histogram_estimate'] == hist
    assert abs(hist - exact) < 1e-3


def test_evaluator_confusion_matrices_match_jax(sweeps):
    loader, out = sweeps
    jev, _, ev, _ = out['histogram']
    jacc = _jax_acc(jev, loader)
    cm = ev.last_acc['cm'].numpy()
    assert cm.dtype == np.int64 and cm.shape == (5, C, C)
    for w in range(5):
        n = sum(int((b['label'][b['weather_id'] == w] != 255).sum())
                for b in loader)
        assert cm[w].sum() == n == int(jacc['cm'][1 + w].sum())
        moved = np.abs(cm[w] - jacc['cm'][1 + w]).sum() / 2
        assert moved <= 1e-3 * n, (w, moved)
    assert (cm.sum((0, 1)) > 0).sum() > 2                  # not one class
    ece = ev.last_acc['ece'].numpy()
    np.testing.assert_array_equal(ece[..., 0].sum(-1), cm.sum((1, 2)))
    hist = ev.last_acc['auroc_hist'].numpy()
    assert hist.sum() == cm.sum() == int(jacc['auroc_hist'].sum())


def test_evaluator_on_cpu_launches_no_kernel(sweeps):
    for fn in (attention.sr_attention, headkernels.seg_core,
               splat.splat_coverage_batched):
        assert fn.launches == 0, fn.__name__


# ------------------------------------------- the sweep on a stand-in model

NC = 4


class _TorchMembers(nn.Module):
    """Two per-pixel linear members and their mean, the ensemble's keys."""

    def __init__(self, w1, w2):
        super().__init__()
        self.w1 = nn.Parameter(torch.from_numpy(w1))
        self.w2 = nn.Parameter(torch.from_numpy(w2))

    def forward(self, x):
        m1, m2 = x @ self.w1, x @ self.w2
        return {'segmentation': (m1 + m2) / 2, 'segformer_seg': m1,
                'deeplabv3plus_seg': m2}


class _FlaxMembers(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        w1 = self.param('w1', fnn.initializers.zeros, (3, NC))
        w2 = self.param('w2', fnn.initializers.zeros, (3, NC))
        m1, m2 = x @ w1, x @ w2
        return {'segmentation': (m1 + m2) / 2, 'segformer_seg': m1,
                'deeplabv3plus_seg': m2}


@pytest.fixture(scope='module')
def members():
    rng = np.random.default_rng(9)
    w1, w2 = (rng.standard_normal((3, NC)).astype(np.float32) * s
              for s in (2.0, 1.0))
    return (lambda: _TorchMembers(w1, w2), _FlaxMembers(),
            {'params': {'w1': jnp.asarray(w1), 'w2': jnp.asarray(w2)}})


def _small(n=2):
    return _loader(seed=4, n=n, h=16, w=24, c=NC)


@pytest.mark.parametrize('mode', MODES)
def test_evaluator_logic_matches_jax_on_stand_in(members, mode):
    make, jmodel, variables = members
    loader = _small()
    config = {'model': {'num_classes': NC}, 'tpu': {'precision': 'fp32'}}
    _, jres = _jax_run(jmodel, variables, loader, mode, config)
    res = evaluator.Evaluator(make(), config, auroc_mode=mode,
                              device='cpu').run(loader, seed=SEED,
                                                draws=_draws(loader))
    assert res.keys() == jres.keys()
    for k, v in jres.items():
        if not k.startswith('_') or k == '_auroc_histogram_estimate':
            assert abs(res[k] - v) <= 2e-3, (k, res[k], v)


def test_exact_mode_memory_guard_falls_back_to_histogram(members, caplog):
    make, _, _ = members
    config = {'model': {'num_classes': NC}, 'tpu': {'precision': 'fp32'},
              'evaluation': {'auroc_mode': 'exact',
                             'exact_auroc_max_bytes': 2 * B * 16 * 24 * 5 - 1}}
    ev = evaluator.Evaluator(make(), config, device='cpu')
    assert ev.auroc_mode == 'exact'
    with caplog.at_level(logging.WARNING):
        res = ev.run(_small(), seed=1)
    assert ev.auroc_mode == 'histogram'
    assert 'exact_auroc_max_bytes' in caplog.text
    assert 'ensemble_disagreement_auroc' in res
    assert '_auroc_histogram_estimate' not in res
    config['evaluation']['exact_auroc_max_bytes'] += 1    # fits: stays exact
    ev = evaluator.Evaluator(make(), config, device='cpu')
    assert '_auroc_histogram_estimate' in ev.run(_small(), seed=1)
    assert ev.auroc_mode == 'exact'


def test_exact_mode_needs_a_sized_loader(members):
    make, _, _ = members
    ev = evaluator.Evaluator(make(), {'model': {'num_classes': NC}},
                             auroc_mode='exact', device='cpu')
    with pytest.raises(ValueError, match='sized loader'):
        ev.run(iter(_small()))
    res = evaluator.Evaluator(make(), {'model': {'num_classes': NC}},
                              auroc_mode='exact_host', device='cpu').run(
                                  iter(_small()))
    assert res['_num_images'] == 2 * B


def test_empty_sweep_matches_jax(members):
    make, jmodel, variables = members
    config = {'model': {'num_classes': NC}}
    _, jres = _jax_run(jmodel, variables, [], 'histogram', config)
    res = evaluator.Evaluator(make(), config, device='cpu').run([])
    assert res.keys() == jres.keys()
    assert res['overall_miou'] == jres['overall_miou'] == 0.0
    assert res['_num_images'] == 0


def test_evaluator_config_errors_and_device(members):
    make, _, _ = members
    with pytest.raises(NotImplementedError, match='item 7'):
        evaluator.Evaluator(make(), {'evaluation': {'spatial_tiling': 'on'}},
                            device='cpu')
    with pytest.raises(ValueError, match='auroc_mode'):
        evaluator.Evaluator(make(), {}, auroc_mode='sorted', device='cpu')
    ev = evaluator.Evaluator(make(), {}, collect_exact_auroc=True,
                             device='cpu')
    assert ev.auroc_mode == 'exact_host' and ev.collect_exact_auroc
    assert ev.dtype == torch.bfloat16           # the default bf16 policy
    assert next(ev.model.parameters()).dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            evaluator.Evaluator(make(), {})


def test_report_files_match_jax(sweeps, tmp_path):
    _, out = sweeps
    res = out['exact'][3]
    evaluator.generate_evaluation_report(res, tmp_path / 'torch')
    jevaluator.generate_evaluation_report(res, tmp_path / 'jax')
    for name in ('evaluation_results.json', 'evaluation_report.md'):
        assert ((tmp_path / 'torch' / name).read_text()
                == (tmp_path / 'jax' / name).read_text())
    assert '| miou_clean |' in (tmp_path / 'torch'
                                / 'evaluation_report.md').read_text()
