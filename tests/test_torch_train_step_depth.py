"""The port's train step with depth heads against the JAX package's, on the
CPU: the body of ``bench.py``'s train step with ``include_depth=True``, its
configuration.

As in tests/test_torch_train_step.py (whose helpers this file shares): the
JAX model runs its unfused XLA heads on the CPU, and
``flax.linen.intercept_methods`` gives each Flax ``nn.Dropout`` the mask
the port draws, picked by the module's path: the seg head, the SegFormer
depth head and the DeepLab depth head get the counter-hash masks of three
seeds (one per head, as each Flax module draws its own dropout key), ASPP
an explicit mask. The port's ``TrainStep`` (plain versions on the CPU) gets
the same weights and every draw of the JAX step, and its depth target is
the depth estimated from the corrupted images before the flip, as JAX's.

Held in f32: the total, segmentation and depth losses within 1e-4
relative, the updated BN running statistics within 1e-4, and the gradients
of the SegFormer member (both heads) and the ensemble's weight and
temperature within rtol 2e-3 and 2e-3 of the leaf's largest value. The
DeepLab member's gradients (its depth head's included) are held in f64 on
both sides, at the same tolerance, for the conditioning reason given in
that file. Leaves whose gradient is zero analytically (conv biases before a
train-mode BN, the key projection's bias under the softmax) are held
negligible on both sides.

The seg head's conv kernel is the worst conditioned SegFormer leaf: its
batch-stat gradient moves by up to 3e-3 of its scale under the f32-level
differences of the two frameworks' encoder features, depending on the
batch (with this fog/snow batch JAX's own f32 gradient lies 8e-4 of the
scale from its f64 one and the port's 3e-4; with a rain/night batch tried
first, JAX's 1.5e-5 and the port's 3e-3).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.data import pipeline as jpipe
from awsegbench.losses.fog_density import FogDensityAwareLoss as JLoss
from awsegbench.models import ensemble as jensemble
from awsegbench.ops import headkernels_train as jht
from awsegbench.train.trainer import fog_density_from_weather as jfog
from awsegbench.weather import corruption as jcorr
from awsegbench.weather.depth import estimate_depth_batch as jdepth
from awsegbench_torch import _build
from awsegbench_torch.convert import flax_to_torch, torch_to_flax
from awsegbench_torch.core.precision import Policy
from awsegbench_torch.data.pipeline import prepare_batch
from awsegbench_torch.losses.fog_density import FogDensityAwareLoss
from awsegbench_torch.models.ensemble import EnsembleModel
from awsegbench_torch.ops import depthkernels_train, splat
from awsegbench_torch.train.optim import create_optimizer
from awsegbench_torch.train.step import TrainStep
from awsegbench_torch.train.trainer import fog_density_from_weather, \
    train_step
from test_torch_models import random_variables
from test_torch_train_step import _flat, _hold, _jax_aug_draws
from test_torch_weather import _jax_draws

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, W, C = 2, 64, 128, 19
SEEDS = {'seed': -123456789, 'segformer_depth_seed': 24681357,
         'deeplab_depth_seed': -2 ** 31}
# each nn.Dropout of the JAX model, by module path → the port's draw
DROPOUTS = {('segformer', 'SegmentationHead_0'): 'seed',
            ('segformer', 'DepthEstimationHead_0'): 'segformer_depth_seed',
            ('deeplabv3plus', 'DepthEstimationHead_0'): 'deeplab_depth_seed',
            ('deeplabv3plus', 'ASPP_0'): 'aspp_mask'}


def _jax_prepare(images, labels, wids, keys, aug_key):
    """The body of JAX's ``prepare_batch(train=True, include_depth=True)``
    with the corruption op by op: under ``jit`` XLA's CPU backend contracts
    the rain blur's multiply-adds, which moves a tenth of the rain image's
    uint8 values by one step (tests/test_torch_weather.py)."""
    corrupted = jcorr._corrupt_batch_fused(images, wids, keys)
    depth = jdepth(corrupted)                   # before the flip
    corrupted, labels = jpipe._train_augment(corrupted, labels, aug_key)
    return {'image': jpipe.normalize_imagenet(corrupted), 'label': labels,
            'depth': depth}


@pytest.fixture(scope='module')
def step_pair():
    rng = np.random.default_rng(33)
    images = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    labels = rng.integers(0, C, (B, H, W)).astype(np.int32)
    labels[:, :3] = 255                                  # ignored rows
    wids = np.array([1, 3], np.int32)                    # fog, snow
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    aug_key, fog_key = jax.random.PRNGKey(9), jax.random.PRNGKey(10)
    masks = {'aspp_mask': rng.random((B, H // 16, W // 16, 256)) < 0.5}
    # the hash masks, drawn once (the JAX hash runs in int32 arithmetic,
    # outside the f64 run's x64 mode)
    for name, shape in (('seed', (B, H, W, 256)),
                        ('segformer_depth_seed', (B, H, W, 128)),
                        ('deeplab_depth_seed', (B, H // 16, W // 16, 256))):
        masks[name] = np.asarray(jht.dropout_keep_mask(
            shape, jnp.int32(SEEDS[name]), 0.1))

    jmodel = jensemble.EnsembleModel(num_classes=C, include_depth=True,
                                     head_mode='faithful')
    variables = random_variables(jmodel, images[:1].astype(np.float32),
                                 train=False)
    seen = set()

    def dropout(next_fun, args, kwargs, context):
        if not (isinstance(context.module, fnn.Dropout)
                and context.method_name == '__call__'):
            return next_fun(*args, **kwargs)
        x, rate = args[0], context.module.rate
        name = DROPOUTS[context.module.scope.path[:2]]
        seen.add(name)
        assert masks[name].shape == x.shape, name
        return jnp.where(jnp.asarray(masks[name]), x / (1.0 - rate), 0.0)

    def jax_step(variables, image, targets, fog):
        """(losses, new batch stats, grads) of the JAX step, jitted."""
        def loss_of(p):
            with fnn.intercept_methods(dropout):
                out, mut = jmodel.apply(
                    {'params': p, 'batch_stats': variables['batch_stats']},
                    image, train=True, mutable=['batch_stats'])
            out = {k: o.astype(image.dtype) for k, o in out.items()}
            ld = JLoss()(out, targets, fog)
            return ld['total_loss'], (ld, mut['batch_stats'])
        return jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
            variables['params'])

    with jax.default_matmul_precision('float32'):
        prep = _jax_prepare(jnp.asarray(images), jnp.asarray(labels),
                            jnp.asarray(wids), keys, aug_key)
        fog = jfog(jnp.asarray(wids), fog_key, H, W)
        targets = {'label': prep['label'], 'depth': prep['depth']}
        (_, (losses, new_bs)), grads = jax_step(variables, prep['image'],
                                                targets, fog)
        with jax.enable_x64(True):
            f64 = lambda t: jax.tree_util.tree_map(          # noqa: E731
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
            _, grads64 = jax_step(f64(variables), f64(prep['image']),
                                  {'label': prep['label'],
                                   'depth': f64(prep['depth'])}, f64(fog))
    assert seen == set(DROPOUTS.values())

    model = EnsembleModel(num_classes=C, include_depth=True,
                          head_mode='faithful')
    model.load_state_dict(flax_to_torch(variables), strict=True)
    # plain SGD at lr 0, no clip: the step leaves the parameters as they
    # were and the raw gradients in .grad
    sgd0 = {'type': 'sgd', 'learning_rate': 0.0, 'momentum': 0.0,
            'weight_decay': 0.0}
    step = TrainStep(model, optimizer=create_optimizer(
        model.parameters(), sgd0, grad_clip=0.0), precision='fp32',
        device='cpu')
    aug = _jax_aug_draws(aug_key)
    to_t = lambda x: torch.from_numpy(np.array(x))      # noqa: E731
    draws = {'corruption': _jax_draws(keys, H, W),
             'augment': {k: to_t(v) for k, v in aug.items()},
             'fog_u': to_t(jax.random.uniform(fog_key, (B, H, W))),
             'aspp_mask': torch.from_numpy(masks['aspp_mask']),
             **{k: torch.tensor(v, dtype=torch.int32)
                for k, v in SEEDS.items()}}
    images_t, labels_t, wids_t = (torch.from_numpy(a)
                                  for a in (images, labels, wids))
    got = step(images_t, labels_t, wids_t, draws=draws)

    def port_grads(m):
        return dict(_flat(torch_to_flax({
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in m.named_parameters()})['params']))

    # the same step in f64: the body of TrainStep, on the f64 model
    model64 = EnsembleModel(num_classes=C, include_depth=True,
                            head_mode='faithful')
    model64.load_state_dict(flax_to_torch(variables), strict=True)
    model64.double().train()
    prep_t = prepare_batch(images_t, labels_t, wids_t,
                           draws=draws['corruption'], include_depth=True,
                           train=True, aug_draws=draws['augment'])
    f64 = torch.float64
    train_step(model64, create_optimizer(model64.parameters(), sgd0,
                                         grad_clip=0.0),
               FogDensityAwareLoss(), Policy(f64, f64),
               prep_t['image'].double(),
               {'label': prep_t['label'], 'depth': prep_t['depth'].double()},
               fog_density_from_weather(wids_t, H, W,
                                        u=draws['fog_u']).double(),
               draws['seed'], draws['aspp_mask'],
               depth_seeds={k: draws[k] for k in ('segformer_depth_seed',
                                                  'deeplab_depth_seed')})
    port_stats = torch_to_flax(dict(model.named_buffers()))['batch_stats']
    return {'loss': got, 'jloss': {k: float(v) for k, v in losses.items()},
            'jgrads': dict(_flat(jax.device_get(grads))),
            'grads': port_grads(model),
            'jgrads64': dict(_flat(jax.device_get(grads64))),
            'grads64': port_grads(model64),
            'jstats': dict(_flat(jax.device_get(new_bs))),
            'stats': dict(_flat(port_stats)),
            'before': dict(_flat(variables['batch_stats']))}


@pytest.mark.parametrize('name', ['total_loss', 'segmentation_loss',
                                  'depth_loss'])
def test_depth_train_step_losses_match_jax(step_pair, name):
    got, want = step_pair['loss'][name].item(), step_pair['jloss'][name]
    assert np.isfinite(want) and want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_depth_train_step_gradients_match_jax_f32(step_pair):
    """The SegFormer member (both heads through the plain versions of
    K7/K8 and K9/K10) and the ensemble's own parameters, in f32."""
    jgrads, grads = step_pair['jgrads'], step_pair['grads']
    assert jgrads.keys() == grads.keys()
    names = [n for n in jgrads if not n.startswith('deeplabv3plus/')]
    assert any('DepthEstimationHead_0' in n for n in names)
    _hold(grads, jgrads, names)
    # the fused heads route conv1's bias into the BN mean only
    for head in ('SegmentationHead_0', 'DepthEstimationHead_0'):
        assert not grads[f'segformer/{head}/Conv_0/bias'].any(), head


def test_depth_train_step_gradients_match_jax_f64(step_pair):
    """Every parameter, the DeepLab member's depth head included, in f64."""
    jgrads, grads = step_pair['jgrads64'], step_pair['grads64']
    assert jgrads.keys() == grads.keys() == step_pair['jgrads'].keys()
    assert 'deeplabv3plus/DepthEstimationHead_0/Conv_1/kernel' in grads
    _hold(grads, jgrads, list(jgrads))


def test_depth_train_step_batch_stats_match_jax(step_pair):
    jstats, stats, before = (step_pair[k] for k in ('jstats', 'stats',
                                                    'before'))
    assert jstats.keys() == stats.keys() == before.keys()
    assert sum('DepthEstimationHead_0' in n for n in jstats) == 8
    for name, want in jstats.items():
        np.testing.assert_allclose(stats[name], want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        assert not np.array_equal(want, before[name]), name  # train-mode BN


def test_depth_train_step_on_cpu_launches_no_kernel(step_pair):
    for fn in (depthkernels_train.d1_core_train,
               depthkernels_train.d1_core_train_backward,
               splat.splat_coverage_batched):
        assert _build.launches[fn.__name__] == 0, fn.__name__
