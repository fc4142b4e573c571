"""Remat (``model.remat`` / ``tpu.remat``): each MiT block checkpointed in
training, against the same model without it and against the JAX package's
``nn.remat`` train step, on the CPU.

* With remat on and off, a small MiT's train-mode gradients are bit-equal
  (f32, and bf16 compute through the precision policy's casts) and the
  state-dict keys are the same.
* The checkpoint is called once per block in train mode under autograd,
  never in eval or under ``no_grad``.
* ``model.remat`` overrides ``tpu.remat``, as in ``awsegbench/models/
  factory.py``.
* The train step of a SegFormer member with remat on matches JAX's
  ``SegFormerModel(remat=True)`` train step in f64, at the gradient
  tolerance of ``tests/test_torch_train_step.py``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from awsegbench.losses.fog_density import FogDensityAwareLoss as JLoss
from awsegbench.models import segformer as jsegformer
from awsegbench.ops import headkernels_train as jht
from awsegbench_torch.convert import flax_to_torch, torch_to_flax
from awsegbench_torch.core.precision import Policy, get_policy
from awsegbench_torch.losses.fog_density import FogDensityAwareLoss
from awsegbench_torch.models import segformer
from awsegbench_torch.models.factory import create_model
from awsegbench_torch.train.optim import create_optimizer
from awsegbench_torch.train.trainer import train_step
from test_torch_models import random_variables
from test_torch_train_step import _flat, _hold

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL = {'type': 'segformer', 'num_classes': 5, 'include_depth': True,
         'segformer_variant': 'b0'}


def _model(remat, seed=1):
    return create_model({'model': dict(SMALL, remat=remat)}, device='cpu',
                        seed=seed)


def _grads(remat, precision):
    """Train-mode gradients of a squared-logit loss through the policy's
    cast, as ``train_step`` runs the forward."""
    model = _model(remat).train()
    policy = get_policy(precision)
    x = torch.randn((2, 64, 96, 3), generator=torch.Generator().manual_seed(0))
    seeds = {'seed': torch.tensor(7, dtype=torch.int32),
             'depth_seed': torch.tensor(-9, dtype=torch.int32)}
    out = functional_call(model, policy.cast_to_compute(model),
                          (x.to(policy.compute_dtype),), seeds)
    (out['segmentation'].float().square().sum()
     + out['depth'].float().sum()).backward()
    return model, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
def test_remat_gradients_bit_equal(precision):
    m0, g0 = _grads(False, precision)
    m1, g1 = _grads(True, precision)
    assert m1.MiTEncoder_0.remat and not m0.MiTEncoder_0.remat
    assert g0.keys() == g1.keys()
    for name, g in g0.items():
        if g is None:             # the fused heads' conv1 bias: no gradient
            assert g1[name] is None, name
            continue
        assert torch.equal(g, g1[name]), name
    assert any(n.startswith('MiTEncoder_0.') and g is not None
               for n, g in g0.items())


def test_remat_state_dict_keys_unchanged():
    a, b = _model(False).state_dict(), _model(True).state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    ens = {'type': 'ensemble', 'num_classes': 3}
    assert list(create_model({'model': dict(ens, remat=True)},
                             device='cpu').state_dict()) == \
        list(create_model({'model': ens}, device='cpu').state_dict())


def test_checkpoint_only_in_train_mode_with_grad(monkeypatch):
    calls = []
    real = segformer.checkpoint

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(segformer, 'checkpoint', counting)
    model = _model(True)
    x = torch.randn((1, 32, 64, 3))
    seeds = {'seed': torch.tensor(1, dtype=torch.int32),
             'depth_seed': torch.tensor(2, dtype=torch.int32)}
    with torch.no_grad():
        model.eval()(x)
        model.train()(x, **seeds)
    model.eval()(x)
    assert calls == []
    model.train()(x, **seeds)['segmentation'].sum().backward()
    assert len(calls) == sum(model.MiTEncoder_0.depths) == 8


@pytest.mark.parametrize('cfg,want', [
    ({'model': {}}, False),
    ({'model': {}, 'tpu': {'remat': True}}, True),
    ({'model': {'remat': True}, 'tpu': {'remat': False}}, True),
    ({'model': {'remat': False}, 'tpu': {'remat': True}}, False),
    ({'model': {'remat': True}}, True),
], ids=['default', 'tpu', 'model_over_tpu_off', 'model_off_over_tpu',
        'model'])
def test_model_remat_overrides_tpu_remat(cfg, want):
    for kind in ('segformer', 'ensemble'):
        whole = dict(cfg, model=dict(cfg['model'], type=kind, num_classes=3))
        model = create_model(whole, device='cpu')
        enc = (model if kind == 'segformer' else model.segformer).MiTEncoder_0
        assert enc.remat is want


B, H, W, C = 2, 64, 64, 5
SEED = 424242


@pytest.fixture(scope='module')
def remat_step_pair():
    """JAX's SegFormer train step with ``remat=True`` and the port's with
    remat on, both in f64, on the same weights, batch, fog density and
    dropout mask (JAX's seg-head ``nn.Dropout`` given the port's
    counter-hash mask, as in tests/test_torch_train_step.py)."""
    rng = np.random.default_rng(31)
    image = rng.standard_normal((B, H, W, 3))
    label = rng.integers(0, C, (B, H, W)).astype(np.int32)
    label[:, :2] = 255
    fog = rng.uniform(0, 1, (B, H, W))
    seg_mask = np.asarray(jht.dropout_keep_mask((B, H, W, 256),
                                                jnp.int32(SEED), 0.1))
    jmodel = jsegformer.SegFormerModel(num_classes=C, include_depth=False,
                                       head_mode='faithful', remat=True)
    variables = random_variables(jmodel, image[:1].astype(np.float32),
                                 train=False)

    def dropout(next_fun, args, kwargs, context):
        if not (isinstance(context.module, fnn.Dropout)
                and context.method_name == '__call__'):
            return next_fun(*args, **kwargs)
        x, rate = args[0], context.module.rate
        assert x.shape == seg_mask.shape
        return jnp.where(jnp.asarray(seg_mask), x / (1.0 - rate), 0.0)

    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(          # noqa: E731
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        v64 = f64(variables)

        def loss_of(p):
            with fnn.intercept_methods(dropout):
                out, _ = jmodel.apply(
                    {'params': p, 'batch_stats': v64['batch_stats']},
                    jnp.asarray(image), train=True, mutable=['batch_stats'])
            return JLoss()(out, {'label': jnp.asarray(label)},
                           jnp.asarray(fog))['total_loss']
        loss, grads = jax.jit(jax.value_and_grad(loss_of))(v64['params'])
        jgrads = dict(_flat(jax.device_get(grads)))

    model = segformer.SegFormerModel(C, False, 'faithful', remat=True)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    model.double().train()
    sgd0 = {'type': 'sgd', 'learning_rate': 0.0, 'momentum': 0.0,
            'weight_decay': 0.0}
    f64t = torch.float64
    got = train_step(model, create_optimizer(model.parameters(), sgd0,
                                             grad_clip=0.0),
                     FogDensityAwareLoss(), Policy(f64t, f64t),
                     torch.from_numpy(image), {'label': torch.from_numpy(
                         label).long()}, torch.from_numpy(fog),
                     torch.tensor(SEED, dtype=torch.int32))
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    return {'jloss': float(loss), 'loss': float(got['total_loss']),
            'jgrads': jgrads,
            'grads': dict(_flat(torch_to_flax(grads)['params']))}


def test_remat_train_step_matches_jax_f64(remat_step_pair):
    p = remat_step_pair
    # the port keeps its f32 plain kernels in an f64 run (as
    # tests/test_torch_train_step.py notes): the loss is held at its 1e-4
    np.testing.assert_allclose(p['loss'], p['jloss'], rtol=1e-4)
    assert p['jgrads'].keys() == p['grads'].keys()
    assert any(k.startswith('MiTEncoder_0/SegFormerBlock_') for k in p['grads'])
    # conv1's bias reaches only the BN batch mean, which the normalisation
    # subtracts: zero analytically, exactly zero in the port's fused head,
    # rounding noise in JAX's unfused one
    bias = 'SegmentationHead_0/Conv_0/bias'
    top = max(float(np.abs(g).max()) for g in p['jgrads'].values())
    assert not p['grads'][bias].any()
    assert np.abs(p['jgrads'][bias]).max() < 1e-5 * top
    _hold(p['grads'], p['jgrads'], [k for k in p['jgrads'] if k != bias])
