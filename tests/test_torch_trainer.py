"""The port's trainer (``train/trainer.py``) against the JAX package's, on
the CPU.

Both trainers get a SegFormer-B0 with depth heads at 32×64, 5 classes, in
fp32, with the same weights (seeded values in the shapes of JAX's
variables, carried across by ``flax_to_torch``) and the same two batches
as their train and val loaders. The JAX trainer runs on a one-device mesh.

* ``validate_epoch`` with JAX's draws (its per-sample corruption keys and
  fog uniform, folded from step ``1_000_000_000 + i``): ``val_miou`` and
  each weather's within 2e-3, the losses within 1e-4 relative (the depth
  loss alone within 1e-3, ``RTOL``).
* The first train step's losses with JAX's draws (corruption, flip and
  brightness/contrast, fog uniform) within 1e-4 relative (the depth loss
  alone within 1e-3), as tests/test_torch_train_step.py holds the total
  loss of the step. JAX's model runs its
  unfused heads on the CPU with Flax ``nn.Dropout``; ``intercept_methods``
  gives each the counter-hash mask of the seed the port's head draws from
  (test code only).
* ``train()``: the result and history keys, the learning rate after each
  epoch (cosine and step schedules), the checkpoint names, the TensorBoard
  scalar names, early stopping's epoch, and the resume quirks.
* ``EarlyStopping`` takes JAX's decisions on the same loss sequences and
  restores the same epoch's weights.
"""

import json
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from awsegbench.core.mesh import create_mesh, replicated_sharding
from awsegbench.core.prng import RngStreams as JRngStreams, per_sample_keys
from awsegbench.models.segformer import SegFormerModel as JSegFormer
from awsegbench.ops import headkernels_train as jht
from awsegbench.train import trainer as jtrainer
from awsegbench.train.optim import get_learning_rate, set_learning_rate
from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.losses.fog_density import (FogDensityAwareLoss,
                                                 cross_entropy_loss)
from awsegbench_torch.models.segformer import SegFormerModel
from awsegbench_torch.train import trainer as ptrainer
from test_torch_models import random_variables
from test_torch_weather import _jax_draws

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, W, C, SEED = 2, 32, 64, 5, 7
# The depth losses alone: XLA's CPU backend contracts the jitted rain
# blur's multiply-adds (ROADMAP.md §3), which moves some of the rain
# image's uint8 values by one step, and the depth target is estimated from
# the corrupted image (6e-4 of the train step's depth loss here, 1e-4 of
# validation's); the totals hold at 1e-4. tests/test_torch_weather.py and
# tests/test_torch_train_step_depth.py hold the op-by-op body exactly.
RTOL = {'train_depth_loss': 1e-3, 'val_depth_loss': 1e-3}
DROPOUT_SEEDS = {'SegmentationHead_0': ('seed', -123456789, 256),
                 'DepthEstimationHead_0': ('depth_seed', 24681357, 128)}
CONFIG = {
    'model': {'type': 'segformer', 'num_classes': C, 'include_depth': True,
              'pretrained': False},
    'data': {'apply_augmentation': True},
    'training': {'batch_size': B, 'epochs': 2, 'grad_clip': 1.0},
    'optimizer': {'type': 'adamw', 'learning_rate': 0.001,
                  'weight_decay': 0.01},
    'scheduler': {'enabled': True, 'type': 'cosine', 'eta_min': 1e-6},
    'loss': {'type': 'fog_density_aware'},
    'early_stopping': {'patience': 10, 'min_delta': 0.001},
    'mlflow': {'enabled': False},
    'logging': {'level': 'WARNING', 'progress_bar': False},
    'device': 'cpu', 'seed': SEED,
    'tpu': {'precision': 'fp32'},
}


def _loader(seed, wids, n=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        labels = rng.integers(0, C, (B, H, W)).astype(np.int32)
        labels[:, :2] = 255                                  # ignored rows
        out.append({'image': rng.integers(0, 256, (B, H, W, 3),
                                          dtype=np.uint8),
                    'label': labels,
                    'weather_id': np.asarray(wids[i], np.int32),
                    'sample_id': np.arange(i * B, (i + 1) * B,
                                           dtype=np.int32)})
    return out


TRAIN = _loader(1, [[1, 2]])                                 # fog, rain
VAL = _loader(2, [[0, 2], [4, 3]], n=2)    # clean, rain; night, snow


class _Recorder:
    """A SummaryWriter stand-in that keeps the scalar names."""

    def __init__(self, log_dir=None):
        self.tags = set()

    def add_scalar(self, tag, value, step):
        self.tags.add(tag)

    def close(self):
        pass


def _trainers(tmp_path, config=CONFIG, variables=None, ref=None):
    """Both trainers on the same weights. JAX's starts from ``variables``
    (its own init, eager, takes half a minute at this size) and, given the
    JAX trainer ``ref``, reuses its compiled train and eval steps with its
    optimiser and apply function (the state's static fields, so the
    compiled steps take the new state as they are): the steps are the same
    programs when the configs differ only outside them (schedule, early
    stopping)."""
    jmodel = JSegFormer(num_classes=C, include_depth=True,
                        head_mode='faithful')
    if variables is None:
        variables = random_variables(jmodel, TRAIN[0]['image'][:1]
                                     .astype(np.float32), train=False)
    with mock.patch('awsegbench.models.factory.init_model_variables',
                    lambda *args: variables):
        jt = jtrainer.AdverseWeatherTrainer(
            jmodel, TRAIN, VAL, config,
            checkpoint_dir=str(tmp_path / 'jckpt'),
            log_dir=str(tmp_path / 'jlogs'),
            mesh=create_mesh(devices=jax.devices()[:1]))
    if ref is not None:
        jt._train_step, jt._eval_step, jt.tx = (ref._train_step,
                                                ref._eval_step, ref.tx)
        jt.state = jax.device_put(
            jt.state.replace(apply_fn=ref.state.apply_fn, tx=ref.tx,
                             opt_state=ref.tx.init(jt.state.params)),
            replicated_sharding(ref.mesh))
    # the learning rate as a Python float from the start, as the scheduler
    # writes it after each epoch: one compiled train step serves all epochs
    set_learning_rate(jt.state.opt_state, jt.base_lr)
    model = SegFormerModel(num_classes=C, include_depth=True,
                           head_mode='faithful')
    model.load_state_dict(flax_to_torch(variables), strict=True)
    pt = ptrainer.AdverseWeatherTrainer(
        model, TRAIN, VAL, config, checkpoint_dir=str(tmp_path / 'pckpt'),
        log_dir=str(tmp_path / 'plogs'))
    return jt, pt, variables


def _draws():
    """JAX's draws for the validation batches (each keyed by step
    ``1_000_000_000 + i`` of epoch 0) and for the first train step (step
    0): the per-sample corruption draws of all three batches in one call,
    then each batch's fog uniform, and the train step's augmentation and
    dropout seeds."""
    rngs = JRngStreams(SEED)
    to_t = lambda x: torch.from_numpy(np.array(x))          # noqa: E731
    val = []
    keys = []
    for i, b in enumerate(VAL):
        k_weather, k_fog = jax.random.split(
            rngs.fold('weather', 1_000_000_000 + i), 2)
        keys.append(per_sample_keys(k_weather, jnp.asarray(b['sample_id'])))
        val.append({'fog_u': to_t(jax.random.uniform(k_fog, (B, H, W)))})
    k_weather, k_aug, _, k_fog = jax.random.split(rngs.fold('weather', 0), 4)
    keys.append(per_sample_keys(k_weather,
                                jnp.asarray(TRAIN[0]['sample_id'])))
    k_flip, k_do_bc, k_alpha, k_beta = jax.random.split(k_aug, 4)
    aug = {'do_flip': jax.random.bernoulli(k_flip, 0.5, (B,)),
           'do_bc': jax.random.bernoulli(k_do_bc, 0.3, (B,)),
           'alpha': 1.0 + jax.random.uniform(k_alpha, (B,), minval=-0.2,
                                             maxval=0.2),
           'beta': jax.random.uniform(k_beta, (B,), minval=-0.2, maxval=0.2)}
    train = {'augment': {k: to_t(v) for k, v in aug.items()},
             'fog_u': to_t(jax.random.uniform(k_fog, (B, H, W)))}
    for name, seed, _ in DROPOUT_SEEDS.values():
        train[name] = torch.tensor(seed, dtype=torch.int32)
    corruption = _jax_draws(jnp.concatenate(keys), H, W)
    for i, d in enumerate(val + [train]):
        d['corruption'] = {k: v[i * B:(i + 1) * B]
                           for k, v in corruption.items()}
    return val, train


def _dropout(next_fun, args, kwargs, context):
    """JAX's nn.Dropout → the port head's counter-hash mask."""
    if not (isinstance(context.module, fnn.Dropout)
            and context.method_name == '__call__'):
        return next_fun(*args, **kwargs)
    x, rate = args[0], context.module.rate
    _, seed, channels = DROPOUT_SEEDS[context.module.scope.path[0]]
    assert x.shape == (B, H, W, channels)
    keep = jht.dropout_keep_mask(x.shape, jnp.int32(seed), rate)
    return jnp.where(keep, x / (1.0 - rate), 0.0)


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """Both trainers' validation epoch (JAX's draws), then their first
    train epoch (one step, JAX's draws)."""
    jt, pt, variables = _trainers(tmp_path_factory.mktemp('pair'))
    # the learning rate as the train step returns it (an f32 array), as
    # every later validation sees it: one compiled eval step serves all
    lr = jt.base_lr
    set_learning_rate(jt.state.opt_state, jax.device_put(
        jnp.float32(lr), replicated_sharding(jt.mesh)))
    with jax.default_matmul_precision('float32'):
        jval = jt.validate_epoch()
    set_learning_rate(jt.state.opt_state, lr)
    val_draws, train_draws = _draws()
    val = pt.validate_epoch(draws=val_draws)
    with jax.default_matmul_precision('float32'), \
            fnn.intercept_methods(_dropout):
        jtrain = jt.train_epoch()
    train = pt.train_epoch(draws=[train_draws])
    return {'jval': jval, 'val': val, 'jtrain': jtrain, 'train': train,
            'variables': variables, 'jt': jt}


def test_validate_epoch_matches_jax(pair):
    jval, val = pair['jval'], pair['val']
    assert val.keys() == jval.keys()
    assert {f'val_miou_{w}' for w in ('clean', 'rain', 'snow', 'night')} \
        <= set(val)
    assert val['val_samples'] == jval['val_samples'] == 2 * B
    for k, v in jval.items():
        if 'miou' in k:
            assert abs(val[k] - v) <= 2e-3, (k, val[k], v)
        elif k != 'val_samples':
            np.testing.assert_allclose(val[k], v, rtol=RTOL.get(k, 1e-4),
                                       err_msg=k)
    assert val['val_depth_loss'] > 0


def test_first_train_step_matches_jax(pair):
    jtrain, train = pair['jtrain'], pair['train']
    assert train.keys() == jtrain.keys()
    assert train['train_samples'] == jtrain['train_samples'] == B
    for k in ('train_loss', 'train_seg_loss', 'train_depth_loss'):
        assert np.isfinite(jtrain[k]) and jtrain[k] > 0
        np.testing.assert_allclose(train[k], jtrain[k],
                                   rtol=RTOL.get(k, 1e-4), err_msg=k)
    assert train['train_images_per_sec'] > 0


def test_validation_draws_depend_on_the_step_only(runs):
    """Two validation epochs of the same weights from the port's own
    generators give the same numbers; the first batch's draws do not move
    the second's (each is folded from its index)."""
    _, pt = runs['stop']
    a, b = pt.validate_epoch(), pt.validate_epoch()
    assert a == b
    g0 = pt.rngs.fold('weather', 1_000_000_000, 'cpu')
    g1 = pt.rngs.fold('weather', 1_000_000_001, 'cpu')
    assert not torch.equal(torch.rand(4, generator=g0),
                           torch.rand(4, generator=g1))


def _run_train(trainer, lr_of, keep_every=2):
    """``train()``, recording the learning rate as each epoch's checkpoint
    is written (after the scheduler's step)."""
    lrs, save = [], trainer.save_checkpoint
    trainer.ckpt.keep_every = keep_every

    def record(**kw):
        lrs.append(lr_of(trainer))
        save(**kw)
    trainer.save_checkpoint = record
    return trainer.train(), lrs


def _names(d):
    return sorted(p.name for p in d.iterdir())


def _jlr(t):
    return get_learning_rate(t.state.opt_state)


def _plr(t):
    return t.optimizer.learning_rate


@pytest.fixture(scope='module')
def runs(tmp_path_factory, pair):
    """``train()`` of both trainers from the same weights: two epochs on
    the cosine schedule (TensorBoard scalars recorded); three on the step
    schedule with an early stop that fires after the second (the port
    keeping every epoch's checkpoint); then a fresh pair resumed from the
    first run's 'latest'."""
    root = tmp_path_factory.mktemp('runs')
    out = {'root': root}
    ref, variables = pair['jt'], pair['variables']
    with mock.patch.object(jtrainer, 'SummaryWriter', _Recorder), \
            mock.patch.object(ptrainer, 'SummaryWriter', _Recorder), \
            mock.patch.object(jtrainer, '_TB_AVAILABLE', True), \
            mock.patch.object(ptrainer, '_TB_AVAILABLE', True):
        jt, pt, _ = _trainers(root / 'cosine', CONFIG, variables, ref)
    with jax.default_matmul_precision('float32'):
        out['jres'], out['jlrs'] = _run_train(jt, _jlr)
    out['res'], out['lrs'] = _run_train(pt, _plr)
    out['tags'] = (jt.writer.tags, pt.writer.tags)
    out['cosine'] = (jt, pt)

    stop = dict(CONFIG, training=dict(CONFIG['training'], epochs=3),
                scheduler={'enabled': True, 'type': 'step',
                           'step_size': 1, 'gamma': 0.5},
                early_stopping={'patience': 1, 'min_delta': 1e9,
                                'restore_best_weights': True})
    jt, pt, _ = _trainers(root / 'stop', stop, variables, ref)
    with jax.default_matmul_precision('float32'):
        out['stop_jres'], out['stop_jlrs'] = _run_train(jt, _jlr)
    out['stop_res'], out['stop_lrs'] = _run_train(pt, _plr, 1)
    out['stop'] = (jt, pt)

    jt, pt, _ = _trainers(root / 'resumed', CONFIG, variables, ref)
    jt.load_checkpoint(str(root / 'cosine' / 'jckpt' / 'latest'))
    pt.load_checkpoint(str(root / 'cosine' / 'pckpt' / 'latest'))
    out['resumed'] = (jt, pt)
    return out


def test_train_results_match_jax(runs):
    res, jres = runs['res'], runs['jres']
    assert res.keys() == jres.keys()
    assert res['total_epochs'] == jres['total_epochs'] == 2
    for part in ('train', 'val'):
        assert len(res['history'][part]) == 2
        for got, want in zip(res['history'][part], jres['history'][part]):
            assert got.keys() == want.keys()
            assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize('run', ['', 'stop_'], ids=['cosine', 'step'])
def test_train_learning_rates_match_jax(runs, run):
    lrs, jlrs = runs[run + 'lrs'], runs[run + 'jlrs']
    assert len(lrs) == len(jlrs) == 2
    np.testing.assert_allclose(lrs, jlrs, rtol=1e-6)
    assert lrs[0] < CONFIG['optimizer']['learning_rate']


def test_train_checkpoints_match_jax(runs):
    root = runs['root'] / 'cosine'
    names = _names(root / 'pckpt')
    assert names == _names(root / 'jckpt')
    assert {'latest', 'best', 'epoch_2', 'latest.meta.json'} <= set(names)
    meta = json.loads((root / 'pckpt' / 'latest.meta.json').read_text())
    jmeta = json.loads((root / 'jckpt' / 'latest.meta.json').read_text())
    assert meta.keys() == jmeta.keys() == {'epoch', 'metrics', 'config'}
    assert meta['metrics'].keys() == jmeta['metrics'].keys()
    assert meta['metrics']['scheduler'] == jmeta['metrics']['scheduler']
    assert meta['epoch'] == jmeta['epoch'] == 1
    assert meta['config'] == jmeta['config']


def test_train_scalar_names_match_jax(runs):
    jtags, tags = runs['tags']
    assert tags == jtags
    assert {'Train/Loss', 'Train/SegLoss', 'Train/LR', 'Train/ImagesPerSec',
            'Epoch/TrainLoss', 'Epoch/ValLoss', 'Epoch/ValMIoU'} == tags


def test_early_stopping_in_train_matches_jax(runs):
    """No improvement can clear min_delta after the first epoch: both stop
    after patience epochs and restore the first epoch's weights."""
    jt, pt = runs['stop']
    assert runs['stop_res']['total_epochs'] == \
        runs['stop_jres']['total_epochs'] == 2
    assert pt.early_stopping.early_stop and jt.early_stopping.early_stop
    ckpt = runs['root'] / 'stop' / 'pckpt'
    first, second = (torch.load(ckpt / f'epoch_{n}' / 'model.pt',
                                weights_only=True) for n in (1, 2))
    assert (first['epoch'], second['epoch']) == (0, 1)
    moved = False
    for k, v in pt.model.state_dict().items():
        assert torch.equal(v, first['state_dict'][k]), k
        moved |= not torch.equal(v, second['state_dict'][k])
    assert moved


def test_resume_keeps_jax_quirks(runs):
    """``load_checkpoint`` restores the epoch, the optimiser's step count
    and state and the scheduler, but not ``global_step``; ``train()`` then
    starts again at epoch 0 (the JAX trainer's behaviour)."""
    jt, pt = runs['resumed']
    _, done = runs['cosine']
    assert (pt.current_epoch, pt.step_count, pt.global_step) == \
        (jt.current_epoch, int(jt.state.step), jt.global_step) == (1, 2, 0)
    assert pt.scheduler.state_dict() == jt.scheduler.state_dict()
    assert pt.optimizer.learning_rate == pytest.approx(_jlr(jt))
    want = done.optimizer.state_dict()
    got = pt.optimizer.state_dict()
    assert got['param_groups'] == want['param_groups']
    assert got['state'].keys() == want['state'].keys()
    for i in want['state']:
        for k in want['state'][i]:
            assert torch.equal(got['state'][i][k], want['state'][i][k]), (i, k)
    for k, v in done.model.state_dict().items():
        assert torch.equal(pt.model.state_dict()[k], v), k
    res = pt.train()
    assert res['total_epochs'] == 2 and pt.global_step == 2


@struct.dataclass
class _JState:
    params: dict
    batch_stats: dict


@pytest.mark.parametrize('losses,patience,restore', [
    ([1.0, 0.9, 0.95, 0.96, 0.97, 0.5], 3, True),
    ([1.0, 0.9995, 0.9991, 0.9985, 0.8], 2, True),
    ([2.0, 1.0, 1.5, 0.7, 0.7, 0.7], 2, False),
], ids=['plateau', 'min_delta', 'no_restore'])
def test_early_stopping_matches_jax(losses, patience, restore):
    jes = jtrainer.EarlyStopping(patience=patience, min_delta=0.001,
                                 restore_best_weights=restore)
    es = ptrainer.EarlyStopping(patience=patience, min_delta=0.001,
                                restore_best_weights=restore)
    model = torch.nn.Linear(2, 1)
    for epoch, loss in enumerate(losses):
        with torch.no_grad():
            model.weight.fill_(float(epoch))
        state = _JState(params={'w': jnp.full((2,), float(epoch))},
                        batch_stats={})
        jstop, state = jes(loss, state)
        stop, model = es(loss, model)
        assert (stop, es.counter, es.best_loss) == \
            (jstop, jes.counter, jes.best_loss), epoch
        assert float(model.weight[0, 0].detach()) == \
            float(state.params['w'][0])
        if stop:
            break
    assert es.early_stop == jes.early_stop


class _Pixelwise(torch.nn.Module):
    """A one-layer stand-in with the model interface the trainer reads."""

    include_depth = False

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(3, C)

    def forward(self, x, seed=None):
        return {'segmentation': self.proj(x)}


@pytest.mark.parametrize('loss_type,want', [
    ('fog_density_aware', FogDensityAwareLoss), ('cross_entropy', None),
    ('focal', None)])
def test_loss_selection_matches_jax(tmp_path, loss_type, want):
    """'fog_density_aware' takes the config's FogDensityAwareLoss; any other
    type plain cross-entropy."""
    loss_cfg = {'type': loss_type, 'base_loss': 'focal',
                'fog_sensitivity': 3.0, 'depth_loss_weight': 0.2}
    pt = ptrainer.AdverseWeatherTrainer(
        _Pixelwise(), TRAIN, VAL, dict(CONFIG, loss=loss_cfg),
        checkpoint_dir=str(tmp_path / 'c'), log_dir=str(tmp_path / 'l'))
    jloss = jtrainer.AdverseWeatherTrainer._setup_loss_function(pt)
    if want is None:
        assert pt.loss_fn is cross_entropy_loss
        assert jloss is jtrainer.cross_entropy_loss
        assert pt.train_epoch()['train_depth_loss'] == 0.0
    else:
        assert isinstance(pt.loss_fn, want)
        assert (pt.loss_fn.base_loss, pt.loss_fn.fog_sensitivity,
                pt.loss_fn.depth_loss_weight) == \
            (jloss.base_loss, jloss.fog_sensitivity, jloss.depth_loss_weight)


@pytest.mark.parametrize('config,epochs,clip,classes', [
    ({'epochs': 4, 'training': {'epochs': 9}, 'grad_clip': 0.5,
      'num_classes': 3}, 4, 0.5, 3),
    ({'training': {'epochs': 9, 'grad_clip': 2.0}}, 9, 2.0, C),
], ids=['top_level', 'sections'])
def test_top_level_keys_first(tmp_path, config, epochs, clip, classes):
    cfg = dict(CONFIG, **config)
    pt = ptrainer.AdverseWeatherTrainer(
        _Pixelwise(), TRAIN, VAL, cfg, checkpoint_dir=str(tmp_path / 'c'),
        log_dir=str(tmp_path / 'l'))
    assert (pt.epochs, pt.grad_clip, pt.optimizer.grad_clip,
            pt.num_classes) == (epochs, clip, clip, classes)


def test_trainer_device_and_tpu_keys(tmp_path):
    kw = dict(checkpoint_dir=str(tmp_path / 'c'), log_dir=str(tmp_path / 'l'))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            ptrainer.AdverseWeatherTrainer(_Pixelwise(), TRAIN, VAL,
                                           dict(CONFIG, device='auto'), **kw)
    # a model axis of 2 needs two ranks; one process is a world of 1
    with pytest.raises(ValueError, match='needs 2 devices, have 1'):
        ptrainer.AdverseWeatherTrainer(
            _Pixelwise(), TRAIN, VAL,
            dict(CONFIG, tpu={'mesh_shape': {'data': 1, 'model': 2}}), **kw)
    pt = ptrainer.AdverseWeatherTrainer(
        _Pixelwise(), TRAIN, VAL,
        dict(CONFIG, tpu={'mesh_shape': {'data': 1, 'model': 1}}), **kw)
    assert pt.device == torch.device('cpu')
    assert (pt.mesh.rank, pt.mesh.size) == (0, 1)
