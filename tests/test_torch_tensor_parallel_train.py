"""The mesh's model axis through the trainer, its checkpoints, the sweep and
the train CLI (``awsegbench_torch/train/trainer.py``,
``awsegbench_torch/eval/evaluator.py``, ``awsegbench_torch/cli/``), on
gloo ranks on the CPU (``tests/helpers/torch_dist_worker.py``), against
one rank in this process. The port's analogue of the JAX package's
tests/test_training.py TP cases (a TP epoch against a DP one; the early
stop's restore keeps the layout), held tighter.

* ``{data: 2, model: 2}``: ``AdverseWeatherTrainer`` on the narrow ensemble
  of ``tests/test_eval.py::_TinyEnsemble``'s widths with depth heads
  (``tp_min_features`` 8, clip 1.0, AdamW): one train epoch (two global
  batches of 4) and one validation against one rank: the losses within
  1e-5 relative (f32 sums in another order), the full state after the
  epoch within 2·lr a step of one rank's. AdamW's first steps move each
  parameter by about ±lr, so where a gradient is analytically zero (a
  bias before BN, a key bias) the sign of its rounding noise decides, and
  the second step's forward sees weights that differ by up to 2·lr: the
  BN statistics then agree within 1e-4 and the validation mIoU within
  1e-3 (a few pixels' argmax).
  ``EarlyStopping`` snapshots and restores each rank's slices (the
  layout kept, the values bit-equal), and the trainer steps on after it.
  The ``Evaluator`` on that mesh (full weights, rows and counts over the
  data axis) gives one rank's confusion matrices, AUROC within 1e-6 (its
  histogram's totals equal: the SegFormer member's CPU convs round
  otherwise at 2 rows than at 4, so a few scores change bins) and ECE
  within 1e-6.
* ``{data: 1, model: 2}``: a checkpoint gathered and written by world rank
  0 holds one process's names and shapes and loads into one rank bit for
  bit (parameters, BN statistics, AdamW's moments); a one-process
  checkpoint loads into the sharded trainer as each rank's slices. The
  train CLI as ``torchrun --nproc_per_node 2`` starts it with
  ``tpu.mesh_shape: {data: 1, model: 2}`` (a SegFormer-B0 at the default
  ``tp_min_features`` 64, its 128- to 1024-wide leaves sharded; batches
  of 10 over the synthetic set's 100 train and 20 val images): both
  ranks train the same
  model (their slices concatenated equal the checkpoint it wrote), and
  the evaluate CLI's ranks agree.
"""

import numpy as np
import pytest
import torch

from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.core.mesh import DataMesh, create_mesh
from awsegbench_torch.parallel.tensor import is_sharded
from awsegbench_torch.train.trainer import AdverseWeatherTrainer
from helpers import torch_dist_worker as worker
from test_eval import _TinyEnsemble
from test_torch_models import random_variables

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NC, H, W, B = 5, 32, 64, 4
LR = 1e-3
CONFIG = {
    'model': {'type': 'ensemble', 'num_classes': NC, 'include_depth': True,
              'pretrained': False},
    'training': {'batch_size': B, 'epochs': 1, 'grad_clip': 1.0},
    'optimizer': {'type': 'adamw', 'learning_rate': LR,
                  'weight_decay': 0.01},
    'loss': {'type': 'fog_density_aware'},
    'mlflow': {'enabled': False},
    'logging': {'level': 'WARNING', 'progress_bar': False},
    'device': 'cpu', 'seed': 17,
}


def _config(shape=None):
    tpu = {'precision': 'fp32', 'tp_min_features': 8}
    if shape is not None:
        tpu['mesh_shape'] = shape
    return dict(CONFIG, tpu=tpu)


def _loader(seed, n, wids):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        labels = rng.integers(0, NC, (B, H, W)).astype(np.int32)
        labels[:, :2] = 255
        out.append({'image': rng.integers(0, 256, (B, H, W, 3),
                                          dtype=np.uint8),
                    'label': labels,
                    'weather_id': np.asarray(wids[i], np.int32),
                    'sample_id': np.arange(i * B, (i + 1) * B,
                                           dtype=np.int32)})
    return out


@pytest.fixture(scope='module')
def state():
    x = np.zeros((1, H, W, 3), np.float32)
    return flax_to_torch(random_variables(
        _TinyEnsemble(num_classes=NC, include_depth=True), x, seed=9,
        train=False))


def _payload(state, tmp, shape):
    return {'num_classes': NC, 'state': state, 'config': _config(shape),
            'train': _loader(1, 2, [[1, 2, 3, 4], [0, 2, 4, 1]]),
            'val': _loader(2, 1, [[0, 1, 3, 2]]), 'dir': str(tmp)}


def _sweep_payload(state):
    batches = _loader(3, 2, [[0, 1, 2, 3], [4, 3, 2, 1]])
    return {'num_classes': NC,
            'state': {k: v for k, v in state.items()
                      if 'DepthEstimationHead' not in k},
            'batches': batches,
            'configs': {'histogram': {'model': {'num_classes': NC},
                                      'tpu': {'precision': 'fp32'}}}}


# ---------------------------------------------------------------------------
# {data: 2, model: 2}: the trainer, the early stop, the sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def trainer_runs(state, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('tp_trainer')
    payload = dict(_payload(state, tmp, {'data': 2, 'model': 2}),
                   sweep=_sweep_payload(state))
    ranks = worker.spawn('tp_trainer', payload, tmp / 'spawn', world=4)
    one = worker.tp_trainer(dict(payload, config=_config()), tmp / 'one')
    ref = {'train': one.train_epoch(), 'val': one.validate_epoch(),
           'state': one.model.state_dict(),
           'sweep': worker.sweep_job(payload['sweep'], DataMesh())}
    return ranks, ref


def test_trainer_mesh(trainer_runs):
    ranks, _ = trainer_runs
    assert [r['mesh'] for r in ranks] == [{'data': 2, 'model': 2}] * 4
    assert [r['is_main'] for r in ranks] == [True, False, False, False]


@pytest.mark.parametrize('part', ['train', 'val'])
def test_trainer_epoch_equals_one_rank(trainer_runs, part):
    ranks, ref = trainer_runs
    want = ref[part]
    for r in ranks:
        got = r[part]
        for k, v in want.items():
            if k.endswith('images_per_sec'):
                continue
            if k.endswith('samples'):
                assert got[k] == v, k
            elif 'miou' in k:    # a few argmax flips: see the module doc
                assert abs(got[k] - v) <= 1e-3, k
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_trainer_state_after_epoch_equals_one_rank(trainer_runs):
    ranks, ref = trainer_runs
    for r in ranks:
        for k, want in ref['state'].items():
            got = r['full'][k]
            assert got.shape == want.shape, k
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-4, atol=1e-4, err_msg=k)
            else:
                assert (got - want).abs().max().item() <= 2 * 2 * LR, k


def test_early_stop_restore_keeps_the_shards(trainer_runs):
    ranks, _ = trainer_runs
    for r in ranks:
        res = r['restore']
        assert res['stops'] == [False, True] and res['same_model']
        assert res['equal'] and res['shapes_kept']
        assert res['sharded'] == ranks[0]['restore']['sharded'] != []
        assert np.isfinite(r['after_restore']['train_loss'])


def test_sweep_on_the_2d_mesh_equals_one_rank(trainer_runs):
    ranks, ref = trainer_runs
    want_res, want_acc = ref['sweep']['histogram']
    for r in ranks:
        res, acc = r['sweep']['histogram']
        assert torch.equal(acc['cm'], want_acc['cm'])
        # the SegFormer member's CPU convs round differently at 2 rows than
        # at 4 (1e-6): a few disagreement scores change bins
        assert torch.equal(acc['auroc_hist'].sum(0),
                           want_acc['auroc_hist'].sum(0))
        assert res['ensemble_disagreement_auroc'] == pytest.approx(
            want_res['ensemble_disagreement_auroc'], abs=1e-6)
        np.testing.assert_allclose(acc['ece'].numpy(),
                                   want_acc['ece'].numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert res['overall_miou'] == want_res['overall_miou']
        assert res['_num_images'] == want_res['_num_images'] == 2 * B


# ---------------------------------------------------------------------------
# {data: 1, model: 2}: checkpoints both ways, the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def checkpoint_runs(state, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('tp_ckpt')
    payload = _payload(state, tmp / 'tp', {'data': 1, 'model': 2})
    one = worker.tp_trainer(dict(payload, config=_config()), tmp / 'one')
    one.train_epoch()
    one.train_epoch()
    one.current_epoch = 3
    one.save_checkpoint(3, {'val_miou': 0.25})
    cfg = tmp / 'tiny.yaml'
    cfg.write_text(
        'model: {type: segformer, num_classes: 5, pretrained: false}\n'
        'data: {data_root: /nonexistent, image_size: [32, 64]}\n'
        'training: {batch_size: 10, epochs: 1, num_workers: 1}\n'
        'optimizer: {learning_rate: 0.001}\nmlflow: {enabled: false}\n'
        "logging: {level: WARNING, progress_bar: false}\n"
        'tpu: {mesh_shape: {data: 1, model: 2}, precision: fp32}\n')
    payload.update(one_checkpoint=str(tmp / 'one' / 'c' / 'latest'),
                   cli={'config': str(cfg), 'out': str(tmp / 'cli'),
                        'port': worker.free_port(),
                        'port2': worker.free_port()})
    ranks = worker.spawn('tp_checkpoint', payload, tmp / 'spawn')
    return ranks, one, tmp


def test_tp_checkpoint_loads_on_one_rank(checkpoint_runs):
    ranks, _, tmp = checkpoint_runs
    fresh = worker.tp_trainer(dict(_payload(
        {k: torch.zeros_like(v) for k, v in ranks[0]['full'].items()},
        tmp / 'fresh', None), config=_config()), tmp / 'fresh')
    fresh.load_checkpoint(str(tmp / 'tp' / 'c' / 'latest'))
    sd = fresh.model.state_dict()
    assert sd.keys() == ranks[0]['full'].keys()
    assert all(torch.equal(sd[k], v) for k, v in ranks[0]['full'].items())
    assert not any('parametrizations' in k for k in sd)
    want = ranks[0]['full_optimizer']['state']
    got = fresh.optimizer.inner.state_dict()['state']
    assert got.keys() == want.keys()
    for i, st in want.items():
        assert all(torch.equal(got[i][k], v) for k, v in st.items()), i
    assert all(torch.equal(ranks[0]['full'][k], ranks[1]['full'][k])
               for k in sd)


def test_one_rank_checkpoint_loads_as_slices(checkpoint_runs):
    ranks, one, _ = checkpoint_runs
    full = one.model.state_dict()
    opt = one.optimizer.inner.state_dict()['state']
    params = dict(one.model.named_parameters())
    names = list(params)
    for r in ranks:
        assert r['epoch'] == 3
        sharded = []
        for k, want in full.items():
            got = r['loaded'][k]
            if got.shape != want.shape:
                sharded.append(k)
                n = got.shape[0]
                want = want[r['rank'] * n:(r['rank'] + 1) * n]
            assert torch.equal(got, want), k
        assert sharded
        for i, st in opt.items():
            for key, want in st.items():
                got = r['loaded_optimizer']['state'][i][key]
                if names[i] in sharded and want.ndim:
                    n = got.shape[0]
                    want = want[r['rank'] * n:(r['rank'] + 1) * n]
                assert torch.equal(got, want), (names[i], key)


def test_train_cli_on_a_model_axis(checkpoint_runs):
    ranks, _, tmp = checkpoint_runs
    clis = [r['cli'] for r in ranks]
    assert [(c['rank'], c['size']) for c in clis] == [(0, 2), (1, 2)]
    assert [c['train_loader'] for c in clis] == [(0, 1), (0, 1)]
    latest = torch.load(tmp / 'cli' / 'checkpoints' / 'latest' / 'model.pt',
                        weights_only=False)['state_dict']
    s0, s1 = clis[0]['state'], clis[1]['state']
    n_sharded = 0
    for k, want in latest.items():
        if s0[k].shape == want.shape:
            assert torch.equal(s0[k], want) and torch.equal(s1[k], want), k
        else:
            n_sharded += 1
            assert torch.equal(torch.cat([s0[k], s1[k]]), want), k
    assert n_sharded > 0
    assert (tmp / 'cli' / 'results' / 'training_results.json').is_file()
    e0, e1 = clis[0]['eval'], clis[1]['eval']
    keys = {k for k in e0 if not k.startswith('_')}
    assert 'overall_miou' in keys and all(e0[k] == e1[k] for k in keys)


def test_mesh_shape_model_axis_needs_its_ranks(tmp_path):
    """On one process a model axis of 2 asks for two ranks."""
    with pytest.raises(ValueError, match='needs 2 devices, have 1'):
        create_mesh(mesh_shape={'data': 1, 'model': 2})
    trainer = AdverseWeatherTrainer(
        worker.narrow_ensemble(NC, True), [], [], _config({'data': 1}),
        checkpoint_dir=str(tmp_path / 'c'), log_dir=str(tmp_path / 'l'))
    assert not is_sharded(trainer.model)
