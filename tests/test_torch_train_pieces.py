"""The train step's pieces in the port against the JAX package on the CPU:
BN train semantics, augmentation, fog density, the loss, the optimiser and
the schedulers, the converter's inverse, the entry points' device rule, and
a train forward that makes no tensor from a host value.

Inputs are made with numpy from a seed; random draws are made by JAX and
handed to the port. Tolerances: 1e-6 for f32 elementwise pieces and the
loss (1e-5 where a mean runs over the image), equal uint8 for the
augmentation; the optimiser's parameters after one and two steps on the
same gradients within 1e-6 + 1e-5 relative, 1e-4 of a 1e-2 step (Adam's
m̂/(√v̂ + ε) rounds differently in the two).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode

from awsegbench.data import pipeline as jpipeline
from awsegbench.losses import fog_density as jloss
from awsegbench.models.heads import BatchNormParams
from awsegbench.train import optim as joptim
from awsegbench.train.trainer import fog_density_from_weather as jfog
from awsegbench_torch import _build
from awsegbench_torch.convert import flax_to_torch, torch_to_flax
from awsegbench_torch.core.precision import get_policy
from awsegbench_torch.data.pipeline import apply_augment, draw_augment
from awsegbench_torch.eval.step import EvalStep
from awsegbench_torch.losses import fog_density as tloss
from awsegbench_torch.models import create_model
from awsegbench_torch.models.heads import BatchNorm
from awsegbench_torch.ops import attention, headkernels, headkernels_train, \
    splat
from awsegbench_torch.train import optim
from awsegbench_torch.train.step import TrainStep
from awsegbench_torch.train.trainer import fog_density_from_weather

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- BN

def _bn_inputs(seed, c=6):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 5, 7, c)) * 2 + 1).astype(np.float32)
    params = {'scale': rng.uniform(0.5, 1.5, c).astype(np.float32),
              'bias': rng.standard_normal(c).astype(np.float32)}
    stats = {'mean': rng.standard_normal(c).astype(np.float32),
             'var': rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return x, params, stats


def _torch_bn(params, stats):
    bn = BatchNorm(len(params['scale']))
    bn.load_state_dict(flax_to_torch({'params': params,
                                      'batch_stats': stats}))
    return bn.train()


def test_batchnorm_train_matches_flax():
    """nn.BatchNorm (ConvBNReLU, DeepLab): batch stats, output, and the
    running stats' momentum update with the biased variance."""
    x, params, stats = _bn_inputs(0)
    y, mut = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5).apply(
        {'params': params, 'batch_stats': stats}, x, mutable=['batch_stats'])
    bn = _torch_bn(params, stats)
    got = bn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut['batch_stats']['mean']),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut['batch_stats']['var']),
                               rtol=1e-6, atol=1e-6)
    xf = x.reshape(-1, x.shape[-1]).astype(np.float64)     # biased variance
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 * stats['var'] + 0.1 * xf.var(0),
                               rtol=1e-5)


def test_batchnorm_set_stats_matches_flax():
    """BatchNormParams(set_stats=...) of the fused heads, in f32 and with
    the old stats in bf16 (the JAX step casts batch_stats to bf16)."""
    x, params, stats = _bn_inputs(1)
    mean, var = x.mean((0, 1, 2)), x.var((0, 1, 2))
    for dtype in (jnp.float32, jnp.bfloat16):
        v = {'params': {k: jnp.asarray(a, dtype) for k, a in params.items()},
             'batch_stats': {k: jnp.asarray(a, dtype)
                             for k, a in stats.items()}}
        _, mut = BatchNormParams().apply(
            v, None, features=len(mean), mutable=['batch_stats'],
            set_stats=(jnp.asarray(mean), jnp.asarray(var)))
        bn = _torch_bn(params, stats)
        bn.weight.data = bn.weight.data.to(getattr(torch, jnp.dtype(dtype).name))
        bn.running_mean.copy_(_t(np.asarray(v['batch_stats']['mean'],
                                            np.float32)))
        bn.running_var.copy_(_t(np.asarray(v['batch_stats']['var'],
                                           np.float32)))
        cdt, m = bn.weight.dtype, torch.tensor(0.9, dtype=bn.weight.dtype)
        want = [buf.to(cdt) * m + (1 - 0.9) * _t(new)   # bit for bit
                for buf, new in ((bn.running_mean, mean),
                                 (bn.running_var, var))]
        bn.set_stats(_t(mean), _t(var))
        assert bn.running_mean.dtype == torch.float32
        assert torch.equal(bn.running_mean, want[0])
        assert torch.equal(bn.running_var, want[1])
        np.testing.assert_allclose(
            bn.running_mean.numpy(),
            np.asarray(mut['batch_stats']['mean'], np.float32), rtol=1e-6)
        np.testing.assert_allclose(
            bn.running_var.numpy(),
            np.asarray(mut['batch_stats']['var'], np.float32), rtol=1e-6)


class HostValues(TorchDispatchMode):
    """Counts the tensors made from a host value: ``torch.tensor(v)``
    dispatches ``aten.lift_fresh``. On a card each is a pageable copy that
    waits for the card to drain."""

    LIFTS = (torch.ops.aten.lift_fresh.default,
             torch.ops.aten.lift_fresh_copy.default)

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in self.LIFTS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('precision', ['bf16', 'fp32'])
def test_train_forward_makes_no_tensor_from_a_host_value(precision):
    """The train step's forward (the parameters cast by the policy, the
    ensemble with depth heads in train mode) makes no tensor from a host
    value once its constants exist. While each train-mode BN made its
    momentum with ``torch.tensor(m, device=...)``, this forward made 67:
    one per BN, 64 in DeepLabV3+ and 3 in the SegFormer heads."""
    model = create_model({'type': 'ensemble', 'num_classes': 5,
                          'include_depth': True}, device='cpu').train()
    policy = get_policy(precision)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 64, 3, generator=g).to(policy.compute_dtype)
    seeds = {k: torch.tensor(i, dtype=torch.int32) for i, k in enumerate(
        ('seed', 'segformer_depth_seed', 'deeplab_depth_seed'))}

    def forward():
        functional_call(model, policy.cast_to_compute(model), (x,),
                        {'generator': g, **seeds})

    forward()                       # makes the constants
    with HostValues() as made:
        forward()
    assert made.count == 0


# ---------------------------------------------------------------- data

@pytest.mark.parametrize('key', [0, 1, 6])
def test_augment_with_jax_draws_matches_jax(key):
    rng = np.random.default_rng(key)
    b = 4
    images = rng.integers(0, 256, (b, 6, 9, 3), dtype=np.uint8)
    labels = rng.integers(0, 19, (b, 6, 9)).astype(np.int32)
    k = jax.random.PRNGKey(key)
    want_i, want_l = jpipeline._train_augment(jnp.asarray(images),
                                              jnp.asarray(labels), k)
    k_flip, k_do_bc, k_alpha, k_beta = jax.random.split(k, 4)
    draws = {'do_flip': _t(jax.random.bernoulli(k_flip, 0.5, (b,))),
             'do_bc': _t(jax.random.bernoulli(k_do_bc, 0.3, (b,))),
             'alpha': _t(1.0 + jax.random.uniform(k_alpha, (b,), minval=-0.2,
                                                  maxval=0.2)),
             'beta': _t(jax.random.uniform(k_beta, (b,), minval=-0.2,
                                           maxval=0.2))}
    got_i, got_l = apply_augment(_t(images), _t(labels), draws)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_draw_augment_rates():
    d = draw_augment(20000, torch.Generator().manual_seed(0),
                     torch.device('cpu'))
    assert abs(d['do_flip'].float().mean().item() - 0.5) < 0.02
    assert abs(d['do_bc'].float().mean().item() - 0.3) < 0.02
    assert -0.2 <= d['beta'].min() and d['beta'].max() <= 0.2
    assert 0.8 <= d['alpha'].min() and d['alpha'].max() <= 1.2


def test_fog_density_from_weather_matches_jax():
    wids = np.array([0, 1, 2, 3, 4], np.int32)
    key = jax.random.PRNGKey(3)
    want = jfog(jnp.asarray(wids), key, 6, 8)
    u = jax.random.uniform(key, (5, 6, 8), dtype=jnp.float32)
    got = fog_density_from_weather(_t(wids), 6, 8, u=_t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------- loss

def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    b, h, w, c = 2, 8, 12, 5
    logits = (rng.standard_normal((b, h, w, c)) * 2).astype(np.float32)
    labels = rng.integers(0, c, (b, h, w)).astype(np.int32)
    labels[:, :2] = 255                          # ignored (out of range)
    labels[0, 3, :3] = -1
    depth = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    fog = rng.uniform(0, 1, (b, h, w)).astype(np.float32)
    target_depth = rng.uniform(0, 1, (b, h, w)).astype(np.float32)
    return logits, labels, depth, fog, target_depth


@pytest.mark.parametrize('base', ['cross_entropy', 'focal'])
@pytest.mark.parametrize('case', ['fog', 'fog_from_depth', 'sample_mask'])
def test_fog_density_loss_matches_jax(base, case):
    logits, labels, depth, fog, target_depth = _loss_inputs(len(case))
    preds = {'segmentation': logits}
    targets = {'label': labels}
    fog_in = fog
    mask = None
    if case == 'fog_from_depth':
        preds['depth'] = depth
        targets['depth'] = target_depth
        fog_in = None
    if case == 'sample_mask':
        mask = np.array([1.0, 0.0], np.float32)
    want = jloss.FogDensityAwareLoss(base_loss=base)(
        {k: jnp.asarray(v) for k, v in preds.items()},
        {k: jnp.asarray(v) for k, v in targets.items()},
        None if fog_in is None else jnp.asarray(fog_in),
        sample_mask=None if mask is None else jnp.asarray(mask))
    got = tloss.FogDensityAwareLoss(base_loss=base)(
        {k: _t(v) for k, v in preds.items()},
        {k: _t(v) for k, v in targets.items()},
        None if fog_in is None else _t(fog_in),
        sample_mask=None if mask is None else _t(mask))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert got['total_loss'].item() > 0


def test_ignored_labels_count_in_the_mean():
    """Out-of-range labels add 0 but the mean still divides by every
    pixel (F.cross_entropy's ignore_index mean would not)."""
    logits, labels, *_ = _loss_inputs(7)
    got = tloss._per_pixel_ce(_t(logits), _t(labels))
    valid = (labels >= 0) & (labels < logits.shape[-1])
    assert (got.numpy()[~valid] == 0).all()
    want = jloss.cross_entropy_loss({'segmentation': jnp.asarray(logits)},
                                    {'label': jnp.asarray(labels)})
    got = tloss.cross_entropy_loss({'segmentation': _t(logits)},
                                   {'label': _t(labels)})
    np.testing.assert_allclose(got['total_loss'].item(),
                               float(want['total_loss']), rtol=1e-6)
    np.testing.assert_allclose(
        got['total_loss'].item(),
        tloss._per_pixel_ce(_t(logits), _t(labels)).sum().item()
        / labels.size, rtol=1e-6)


def test_fog_from_depth_matches_jax():
    depth = np.random.default_rng(9).uniform(0, 3, (2, 7, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tloss.estimate_fog_density_from_depth(_t(depth)).numpy(),
        np.asarray(jloss.estimate_fog_density_from_depth(jnp.asarray(depth))),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- optimiser

@pytest.mark.parametrize('cfg', [
    {'type': 'adamw', 'learning_rate': 1e-2, 'weight_decay': 0.1},
    {'type': 'sgd', 'learning_rate': 1e-2, 'weight_decay': 0.1,
     'momentum': 0.9},
    {'type': 'adam', 'learning_rate': 1e-2, 'weight_decay': 0.1},
])
@pytest.mark.parametrize('clip', [0.0, 1.0, 100.0])
def test_optimizer_matches_optax(cfg, clip):
    """One and two steps on the same gradients; the second parameter gets
    a zero gradient (optax still decays it; torch would skip it)."""
    rng = np.random.default_rng(0)
    params = {'a': rng.standard_normal((4, 3)).astype(np.float32),
              'b': rng.standard_normal(5).astype(np.float32)}
    grads = [{'a': (rng.standard_normal((4, 3)) * 2).astype(np.float32),
              'b': np.zeros(5, np.float32)} for _ in range(2)]
    tx = joptim.create_optimizer(cfg, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = optim.create_optimizer(tp.values(), cfg, grad_clip=clip)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        tp['a'].grad = _t(g['a'])          # 'b' has no gradient at all
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    assert not np.array_equal(tp['b'].detach().numpy(), params['b'])
    assert opt.learning_rate == cfg['learning_rate']
    opt.learning_rate = 1e-4
    assert all(g['lr'] == 1e-4 for g in opt.inner.param_groups)


@pytest.mark.parametrize('cfg', [
    {'enabled': True, 'type': 'cosine', 'eta_min': 1e-5},
    {'enabled': True, 'type': 'step', 'step_size': 3, 'gamma': 0.5},
    {'enabled': True, 'type': 'plateau', 'patience': 1, 'factor': 0.5},
    {'enabled': False},
])
def test_schedulers_match_jax(cfg):
    want = joptim.create_scheduler(cfg, 0.1, 10)
    got = optim.create_scheduler(cfg, 0.1, 10)
    if want is None:
        assert got is None
        return
    metrics = [1.0, 0.9, 0.95, 0.97, 0.8, 0.85, 0.9, 0.91, 0.92, 0.93]
    for m in metrics:
        assert got.step(m) == pytest.approx(want.step(m), rel=1e-12)
    assert got.state_dict() == want.state_dict()


# ---------------------------------------------------------------- the rest

def test_torch_to_flax_inverts_flax_to_torch():
    model = create_model({'type': 'ensemble', 'include_depth': False},
                         device='cpu')
    sd = model.state_dict()
    back = flax_to_torch(torch_to_flax(sd))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v.float()), k
    tree = torch_to_flax(sd)
    conv = tree['params']['deeplabv3plus']['ResNetEncoder_0']['Conv_0']
    assert conv['kernel'].shape == (7, 7, 3, 64)                  # HWIO
    assert tree['batch_stats']['segformer']['SegmentationHead_0'][
        'BatchNorm_0'].keys() == {'mean', 'var'}


def test_policy_casts_parameters_for_compute():
    model = torch.nn.Linear(3, 2)
    cast = get_policy('bf16').cast_to_compute(model)
    assert {v.dtype for v in cast.values()} == {torch.bfloat16}
    cast['weight'].float().sum().backward()
    assert model.weight.grad.dtype == torch.float32      # onto the master
    assert get_policy('fp32').cast_to_compute(model)['weight'] is model.weight
    with pytest.raises(ValueError):
        get_policy('fp16')


def test_entry_points_need_a_card_unless_cpu():
    cfg = {'type': 'ensemble', 'num_classes': 19, 'include_depth': False}
    model = create_model(cfg, device='cpu')
    step = TrainStep(model, device='cpu')
    assert step.model.training and not step.include_depth
    depth_step = TrainStep(create_model({'type': 'ensemble'}, device='cpu'),
                           device='cpu')       # bench.py's: with depth heads
    assert depth_step.include_depth and depth_step.model.training
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            TrainStep(model)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            create_model(cfg)


def test_eval_step_without_depth_heads():
    """EvalStep on an include_depth=False ensemble: the confusion matrix
    counts every valid pixel and the depth sum stays 0."""
    model = create_model({'type': 'ensemble', 'num_classes': 5,
                          'include_depth': False}, device='cpu')
    step = EvalStep(model, 5, device='cpu', dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 64, 128, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, 5, (2, 64, 128), generator=g)
    labels[:, :4] = 255
    out = step(images, labels, torch.tensor([2, 4]), generator=g)
    assert 'depth' not in out and out['segmentation'].shape == (2, 64, 128, 5)
    assert int(step.cm.sum()) == int((labels != 255).sum())
    assert step.dsum.item() == 0.0


def test_cpu_train_step_launches_no_kernel():
    model = create_model({'type': 'ensemble', 'num_classes': 19,
                          'include_depth': False}, device='cpu')
    step = TrainStep(model, device='cpu')
    g = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (2, 64, 128, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, 19, (2, 64, 128), generator=g)
    w0 = model.temperature.detach().clone()
    loss = step(images, labels, torch.tensor([1, 2]), generator=g)
    assert np.isfinite(loss['total_loss'].item())
    assert not torch.equal(model.temperature, w0)
    for fn in (attention.sr_attention, attention.sr_attention_backward,
               headkernels.seg_core, headkernels_train.seg_core_train,
               headkernels_train.seg_core_train_backward,
               splat.splat_coverage_batched):
        assert _build.launches[fn.__name__] == 0, fn.__name__


def test_tables_made_in_inference_mode_serve_autograd():
    """A constant table first made by an eval step (inference mode) is
    still usable in a train step's autograd graph."""
    from awsegbench_torch import _device
    from awsegbench_torch.ops.upconv import _upsample1d
    _device._CONSTS.clear()
    with torch.inference_mode():
        _upsample1d(torch.randn(1, 3, 2), 4, 1)
    x = torch.randn(1, 3, 2, requires_grad=True)
    _upsample1d(x, 4, 1).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0


def test_segmentation_head_unfused_train_matches_jax():
    """The seg head's train path without a fused upsample (the 'fused'
    head mode): conv → BN (batch stats) → ReLU → hash dropout → 1×1,
    against JAX's ``SegmentationHead(train=True)`` with its ``nn.Dropout``
    given the same hash mask: output, gradients, BN running stats."""
    from awsegbench.models.heads import SegmentationHead as JHead
    from awsegbench.ops.headkernels_train import dropout_keep_mask
    from awsegbench_torch.models.heads import SegmentationHead
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
    wsum = rng.standard_normal((2, 6, 10, 5)).astype(np.float32)
    seed = 77
    jhead = JHead(num_classes=5, hidden_channels=16)
    v = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def dropout(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout):
            keep = dropout_keep_mask(args[0].shape, jnp.int32(seed), 0.1)
            return jnp.where(keep, args[0] / 0.9, 0.0)
        return next_fun(*args, **kwargs)

    def loss(p):
        with fnn.intercept_methods(dropout):
            y, mut = jhead.apply({'params': p, 'batch_stats': v['batch_stats']},
                                 jnp.asarray(x), train=True,
                                 mutable=['batch_stats'])
        return jnp.sum(y * wsum), (y, mut['batch_stats'])

    with jax.default_matmul_precision('float32'):
        (_, (y, stats)), grads = jax.value_and_grad(loss, has_aux=True)(
            v['params'])
    head = SegmentationHead(8, 5, hidden_channels=16)
    head.load_state_dict(flax_to_torch(v))
    got = head.train()(_t(x), seed=torch.tensor(seed, dtype=torch.int32))
    (got * _t(wsum)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    tgrads = torch_to_flax({n: p.grad for n, p in head.named_parameters()})
    top = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(grads))
    for (path, want), got_g in zip(
            jax.tree_util.tree_leaves_with_path(grads),
            jax.tree_util.tree_leaves(tgrads['params'])):
        scale = float(np.abs(np.asarray(want)).max())
        if scale < 1e-5 * top:      # conv bias before BN: zero analytically
            assert np.abs(got_g).max() < 1e-5 * top, path
            continue
        np.testing.assert_allclose(got_g, np.asarray(want), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(path))
    tstats = torch_to_flax(dict(head.named_buffers()))['batch_stats']
    for k in ('mean', 'var'):
        np.testing.assert_allclose(tstats['BatchNorm_0'][k],
                                   np.asarray(stats['BatchNorm_0'][k]),
                                   rtol=1e-5, atol=1e-6)
