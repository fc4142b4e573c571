"""The port's train step against the JAX package's, on the CPU.

The JAX side is the body of ``bench.py``'s train step with
``include_depth=False``: ``prepare_batch(train=True)`` → fog density →
``EnsembleModel.apply(train=True, mutable=['batch_stats'])`` →
``FogDensityAwareLoss`` → ``jax.value_and_grad``. On the CPU the JAX model
takes its unfused XLA heads with Flax ``nn.Dropout``, whose stream torch
cannot reproduce, so ``flax.linen.intercept_methods`` replaces each
``nn.Dropout`` call (test code only): the seg head's with the counter-hash
mask ``dropout_keep_mask(shape, seed, 0.1)`` the port draws, ASPP's with
an explicit mask handed to the port as well. The port's ``TrainStep``
(plain versions on the CPU) gets the same weights (``flax_to_torch``) and
every draw of the JAX step: corruption, augmentation, fog uniform, dropout.

Held in f32: the loss within 1e-4 relative, the updated BN running
statistics within 1e-4, and the gradients of the SegFormer member and the
ensemble's weight and temperature within rtol 2e-3 and an atol of 2e-3 of
the leaf's largest value (the worst leaf, the seg head's conv kernel, sits
at 6e-4: f32 sums over 16k pixels in the BN batch-stat gradient). The
DeepLab member's gradients are held in f64 on both sides (the same step,
both models cast to f64), at the same tolerance, as is every other leaf:
in f32 they are ill-conditioned here. Through 50 train-mode BNs over a
batch of 2, JAX's own f32 gradient lies up to 13% of the leaf's scale from
the f64 one on some ResNet leaves (and the port's up to 2%), while the
DeepLab member's f64 gradients agree within 1e-7 (the port's SegFormer
keeps its f32 plain kernels in an f64 run).
Leaves whose gradient is zero analytically (the key projection's bias
under the softmax, the fused seg head's conv bias) are held to be
negligible on both sides.

The optimiser is held separately (tests/test_torch_train_pieces.py):
Adam's first step, lr·g/|g|, would turn sign noise on near-zero gradients
into ±lr differences in the parameters.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.data.pipeline import prepare_batch as jprepare_batch
from awsegbench.losses.fog_density import FogDensityAwareLoss as JLoss
from awsegbench.models import ensemble as jensemble
from awsegbench.ops import headkernels_train as jht
from awsegbench.train.trainer import fog_density_from_weather as jfog
from awsegbench_torch import _build
from awsegbench_torch.convert import flax_to_torch, torch_to_flax
from awsegbench_torch.core.precision import Policy
from awsegbench_torch.data.pipeline import prepare_batch
from awsegbench_torch.losses.fog_density import FogDensityAwareLoss
from awsegbench_torch.models.ensemble import EnsembleModel
from awsegbench_torch.ops import attention, headkernels, headkernels_train, \
    splat
from awsegbench_torch.train.optim import create_optimizer
from awsegbench_torch.train.step import TrainStep
from awsegbench_torch.train.trainer import fog_density_from_weather, \
    train_step
from test_torch_models import random_variables
from test_torch_weather import _jax_draws

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, W, C = 2, 64, 128, 19
SEED = -123456789


def _jax_aug_draws(key):
    """``_train_augment``'s draws from its key, as it makes them."""
    k_flip, k_do_bc, k_alpha, k_beta = jax.random.split(key, 4)
    return {'do_flip': jax.random.bernoulli(k_flip, 0.5, (B,)),
            'do_bc': jax.random.bernoulli(k_do_bc, 0.3, (B,)),
            'alpha': 1.0 + jax.random.uniform(k_alpha, (B,), minval=-0.2,
                                              maxval=0.2),
            'beta': jax.random.uniform(k_beta, (B,), minval=-0.2, maxval=0.2)}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield '/'.join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope='module')
def step_pair():
    rng = np.random.default_rng(21)
    images = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    labels = rng.integers(0, C, (B, H, W)).astype(np.int32)
    labels[:, :3] = 255                                  # ignored rows
    wids = np.array([1, 3], np.int32)                    # fog, snow
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    aug_key, fog_key = jax.random.PRNGKey(6), jax.random.PRNGKey(5)
    aspp_mask = rng.random((B, H // 16, W // 16, 256)) < 0.5
    # the seg head's hidden [B, H, W, 256], drawn once (the JAX hash runs in
    # int32 arithmetic, outside the f64 run's x64 mode)
    seg_mask = np.asarray(jht.dropout_keep_mask((B, H, W, 256),
                                                jnp.int32(SEED), 0.1))

    jmodel = jensemble.EnsembleModel(num_classes=C, include_depth=False,
                                     head_mode='faithful')
    variables = random_variables(jmodel, images[:1].astype(np.float32),
                                 train=False)

    def dropout(next_fun, args, kwargs, context):
        if not (isinstance(context.module, fnn.Dropout)
                and context.method_name == '__call__'):
            return next_fun(*args, **kwargs)
        x, rate = args[0], context.module.rate
        mask = aspp_mask if rate == 0.5 else seg_mask
        assert mask.shape == x.shape
        return jnp.where(jnp.asarray(mask), x / (1.0 - rate), 0.0)

    def jax_step(variables, image, label, fog):
        """(loss, new batch stats, grads) of the JAX step, jitted."""
        def loss_of(p):
            with fnn.intercept_methods(dropout):
                out, mut = jmodel.apply(
                    {'params': p, 'batch_stats': variables['batch_stats']},
                    image, train=True, mutable=['batch_stats'])
            out = {k: o.astype(image.dtype) for k, o in out.items()}
            ld = JLoss()(out, {'label': label}, fog)
            return ld['total_loss'], mut['batch_stats']
        return jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
            variables['params'])

    with jax.default_matmul_precision('float32'):
        # eager, op by op: the port's corruption follows that body (see
        # tests/test_torch_weather.py for the jitted one's FMA contraction)
        prep = jprepare_batch(jnp.asarray(images), jnp.asarray(labels),
                              jnp.asarray(wids), keys, aug_key=aug_key,
                              train=True, include_depth=False)
        fog = jfog(jnp.asarray(wids), fog_key, H, W)
        (loss, new_bs), grads = jax_step(variables, prep['image'],
                                         prep['label'], fog)
        with jax.enable_x64(True):
            f64 = lambda t: jax.tree_util.tree_map(          # noqa: E731
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
            _, grads64 = jax_step(f64(variables), f64(prep['image']),
                                  prep['label'], f64(fog))

    model = EnsembleModel(num_classes=C, include_depth=False,
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
    assert np.asarray(aug['do_flip']).any()             # the flip is tested
    to_t = lambda x: torch.from_numpy(np.array(x))      # noqa: E731
    draws = {'corruption': _jax_draws(keys, H, W),
             'augment': {k: to_t(v) for k, v in aug.items()},
             'fog_u': to_t(jax.random.uniform(fog_key, (B, H, W))),
             'seed': torch.tensor(SEED, dtype=torch.int32),
             'aspp_mask': torch.from_numpy(aspp_mask)}
    images_t, labels_t, wids_t = (torch.from_numpy(a)
                                  for a in (images, labels, wids))
    got = step(images_t, labels_t, wids_t, draws=draws)

    def port_grads(m):
        return dict(_flat(torch_to_flax({
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in m.named_parameters()})['params']))

    # the same step in f64: the body of TrainStep, on the f64 model
    model64 = EnsembleModel(num_classes=C, include_depth=False,
                            head_mode='faithful')
    model64.load_state_dict(flax_to_torch(variables), strict=True)
    model64.double().train()
    prep_t = prepare_batch(images_t, labels_t, wids_t,
                           draws=draws['corruption'], include_depth=False,
                           train=True, aug_draws=draws['augment'])
    f64 = torch.float64
    train_step(model64, create_optimizer(model64.parameters(), sgd0,
                                         grad_clip=0.0),
               FogDensityAwareLoss(), Policy(f64, f64),
               prep_t['image'].double(), {'label': prep_t['label']},
               fog_density_from_weather(wids_t, H, W,
                                        u=draws['fog_u']).double(),
               draws['seed'], draws['aspp_mask'])
    port_stats = torch_to_flax(dict(model.named_buffers()))['batch_stats']
    return {'loss': got, 'jloss': float(loss),
            'jgrads': dict(_flat(jax.device_get(grads))),
            'grads': port_grads(model),
            'jgrads64': dict(_flat(jax.device_get(grads64))),
            'grads64': port_grads(model64),
            'jstats': dict(_flat(jax.device_get(new_bs))),
            'stats': dict(_flat(port_stats)),
            'before': dict(_flat(variables['batch_stats']))}


def _hold(got, want, names):
    """rtol 2e-3, atol 2e-3 of the leaf's scale; leaves whose scale is
    below 1e-6 of the largest are analytically zero and held negligible."""
    top = max(float(np.abs(w).max()) for w in want.values())
    for name in names:
        scale = float(np.abs(want[name]).max())
        if scale < 1e-6 * top:
            assert np.abs(got[name]).max() < 1e-6 * top, name
            continue
        np.testing.assert_allclose(got[name], want[name], rtol=2e-3,
                                   atol=2e-3 * scale, err_msg=name)


def test_train_step_loss_matches_jax(step_pair):
    got, loss = step_pair['loss'], step_pair['jloss']
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(got['total_loss'].item(), loss, rtol=1e-4)
    np.testing.assert_allclose(got['segmentation_loss'].item(), loss,
                               rtol=1e-4)
    assert got['depth_loss'].item() == 0.0


def test_train_step_gradients_match_jax_f32(step_pair):
    """The SegFormer member (K6, K7/K8's plain versions) and the ensemble's
    own parameters, in f32."""
    jgrads, grads = step_pair['jgrads'], step_pair['grads']
    assert jgrads.keys() == grads.keys()
    names = [n for n in jgrads if not n.startswith('deeplabv3plus/')]
    assert {'ensemble_weights', 'temperature'} <= set(names)
    _hold(grads, jgrads, names)
    # the fused seg head routes conv1's bias into the BN mean only
    assert not grads['segformer/SegmentationHead_0/Conv_0/bias'].any()


def test_train_step_gradients_match_jax_f64(step_pair):
    """Every parameter, the DeepLab member's included, in f64."""
    jgrads, grads = step_pair['jgrads64'], step_pair['grads64']
    assert jgrads.keys() == grads.keys() == step_pair['jgrads'].keys()
    _hold(grads, jgrads, list(jgrads))


def test_train_step_batch_stats_match_jax(step_pair):
    jstats, stats, before = (step_pair[k] for k in ('jstats', 'stats',
                                                    'before'))
    assert jstats.keys() == stats.keys() == before.keys()
    for name, want in jstats.items():
        np.testing.assert_allclose(stats[name], want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        assert not np.array_equal(want, before[name]), name  # train-mode BN


def test_train_step_on_cpu_launches_no_kernel(step_pair):
    for fn in (attention.sr_attention, attention.sr_attention_backward,
               headkernels.seg_core, headkernels_train.seg_core_train,
               headkernels_train.seg_core_train_backward,
               splat.splat_coverage_batched):
        assert _build.launches[fn.__name__] == 0, fn.__name__
