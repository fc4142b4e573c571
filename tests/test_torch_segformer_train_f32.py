"""Where the port's f32 SegFormer member departs from f64 in train mode,
against the JAX package, on the CPU.

The reference is the JAX member in f64 with its heads unfused
(``fused_upsample=False``: the bilinear upsample materialised, then plain
convs and batch-stat BNs), which is f64 throughout; the fused
``upsample_conv3x3`` asks its einsums for f32 results and is not. Dropout
is off (rate 0) or the counter-hash masks the port draws, given to JAX's
``nn.Dropout`` calls through ``flax.linen.intercept_methods``. B = 2,
64×128, full-width MiT-B0, seeded weights.

Measured here (max |Δ| over the reference's max): the port's encoder
stages sit 0.7–1.6e-6 from f64 (JAX's f32 0.5–0.7e-6), its BN running
statistics 0.3–2.7e-6, and its train-mode seg logits 9.1e-6 (JAX's f32
CPU path 2.4e-6). The seg head carries the gap: on the same f32 features
the port's fused train head and JAX's own fused train kernel
(``seg_head_fused_train``, the TPU path, in interpret mode) agree within
8e-7 and both sit 9.7e-6 from f64, while JAX's unfused f32 head sits
1e-6 from it. So the gap is the fused train head's f32 arithmetic (its
batch statistics taken in the coarse domain, as the TPU kernel takes
them), which the port reproduces; it is not a fault of the port.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.models import heads as jheads
from awsegbench.models import segformer as jsegformer
from awsegbench.ops import headkernels_train as jht
from awsegbench.ops.resize import upsample_like
from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.models.segformer import SegFormerModel
from awsegbench_torch.ops import headkernels_train
from test_torch_models import random_variables

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, W, C = 2, 64, 128, 19
SEED, DEPTH_SEED = -123456789, 24681357
HIDDEN = {256: SEED, 128: DEPTH_SEED}     # each head's hidden width → seed


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


@pytest.fixture(scope='module')
def setup():
    x = np.random.default_rng(0).standard_normal((B, H, W, 3)) \
        .astype(np.float32)
    model = jsegformer.SegFormerModel(num_classes=C, include_depth=True,
                                      head_mode='faithful')
    variables = random_variables(model, x[:1], train=False)
    # the hash masks, drawn outside the f64 runs (JAX's hash is int32)
    masks = {c: np.asarray(jht.dropout_keep_mask((B, H, W, c),
                                                 jnp.int32(s), 0.1))
             for c, s in HIDDEN.items()}
    return x, model, variables, masks


def _jax_member(model, variables, x, masks, rate):
    """(outputs, batch_stats, encoder stages) of the JAX member in train
    mode, each nn.Dropout given the port's mask (or none at rate 0)."""
    def dropout(next_fun, args, kwargs, context):
        if not (isinstance(context.module, fnn.Dropout)
                and context.method_name == '__call__'):
            return next_fun(*args, **kwargs)
        h = args[0]
        if rate == 0.0:
            return h
        return jnp.where(jnp.asarray(masks[h.shape[-1]]), h / (1.0 - rate),
                         0.0)

    with fnn.intercept_methods(dropout):
        out, mut = model.apply(
            variables, x, train=True, mutable=['batch_stats', 'intermediates'],
            capture_intermediates=lambda m, _: isinstance(
                m, jsegformer.MiTEncoder))
    stages = mut['intermediates']['MiTEncoder_0']['__call__'][0]
    return (jax.tree_util.tree_map(np.asarray, out),
            jax.tree_util.tree_map(np.asarray, mut['batch_stats']),
            [np.asarray(s) for s in stages])


@pytest.fixture(scope='module', params=[0.0, 0.1], ids=['rate0', 'hash'])
def member(request, setup):
    x, model, variables, masks = setup
    rate = request.param
    unfused = jsegformer.SegFormerModel(num_classes=C, include_depth=True,
                                        head_mode='faithful',
                                        fused_upsample=False)
    with jax.enable_x64(True):
        ref = _jax_member(unfused, _f64(variables),
                          jnp.asarray(x.astype(np.float64)), masks, rate)
    with jax.default_matmul_precision('float32'):
        jax32 = _jax_member(model, variables, jnp.asarray(x), masks, rate)
    port = SegFormerModel(num_classes=C, include_depth=True,
                          head_mode='faithful')
    port.load_state_dict(flax_to_torch(variables), strict=True)
    port.train()
    port.SegmentationHead_0.dropout = rate
    port.DepthEstimationHead_0.dropout = rate
    with torch.no_grad():
        xt = torch.from_numpy(x)
        stages = [s.numpy() for s in port.MiTEncoder_0(xt)]
        out = port(xt, torch.tensor(SEED, dtype=torch.int32),
                   torch.tensor(DEPTH_SEED, dtype=torch.int32))
    stats = {k: v.numpy() for k, v in port.state_dict().items()
             if 'running' in k}
    return rate, ref, jax32, ({k: v.numpy() for k, v in out.items()},
                              stats, stages)


def test_encoder_stages_sit_at_f32_rounding(member):
    _, ref, jax32, port = member
    for got, want, jgot in zip(port[2], ref[2], jax32[2]):
        assert _rel(jgot, want) < 1e-6
        assert _rel(got, want) < 4e-6


def test_bn_running_stats_sit_at_f32_rounding(member):
    _, ref, jax32, port = member
    for head, bns in (('SegmentationHead_0', ('BatchNorm_0',)),
                      ('DepthEstimationHead_0', ('BatchNorm_0',
                                                 'BatchNorm_1'))):
        for bn in bns:
            for st, buf in (('mean', 'running_mean'), ('var', 'running_var')):
                want = ref[1][head][bn][st]
                assert _rel(jax32[1][head][bn][st], want) < 2e-6
                assert _rel(port[1][f'{head}.{bn}.{buf}'], want) < 6e-6


def test_member_outputs_within_the_fused_heads_rounding(member):
    _, ref, jax32, port = member
    for key in ('segmentation', 'depth'):
        assert _rel(jax32[0][key], ref[0][key]) < 6e-6
        assert _rel(port[0][key], ref[0][key]) < 2e-5


@pytest.mark.parametrize('rate', [0.0, 0.1], ids=['rate0', 'hash'])
def test_seg_head_gap_is_the_fused_train_formulation(setup, rate):
    """On the same f32 features (the f64 encoder's, rounded), the port's
    fused train head equals JAX's fused train kernel (interpret mode)
    within 2e-6 and is no further from f64 than it, while JAX's unfused
    f32 head is at least 3× closer."""
    x, _, variables, masks = setup
    hp = variables['params']['SegmentationHead_0']
    with jax.enable_x64(True):
        feats = jsegformer.MiTEncoder().apply(
            {'params': _f64(variables['params']['MiTEncoder_0'])},
            jnp.asarray(x.astype(np.float64)))[-1]
        f64 = np.asarray(feats)
    f32 = f64.astype(np.float32)
    mask = masks[256] if rate else np.ones((B, H, W, 256), bool)

    def unfused(f, params):
        def dropout(next_fun, args, kwargs, context):
            if isinstance(context.module, fnn.Dropout):
                return jnp.where(jnp.asarray(mask), args[0] / (1.0 - rate),
                                 0.0)
            return next_fun(*args, **kwargs)
        with fnn.intercept_methods(dropout):
            return np.asarray(jheads.SegmentationHead(C).apply(
                {'params': params,
                 'batch_stats': variables['batch_stats']['SegmentationHead_0']},
                upsample_like(f, (H, W)), train=True,
                mutable=['batch_stats'])[0])

    with jax.enable_x64(True):
        ref = unfused(jnp.asarray(f64), _f64(hp))
    args = (hp['Conv_0']['kernel'], hp['Conv_0']['bias'],
            hp['BatchNorm_0']['scale'], hp['BatchNorm_0']['bias'], 1e-5,
            hp['Conv_1']['kernel'], hp['Conv_1']['bias'])
    with jax.default_matmul_precision('float32'):
        jax_unfused = unfused(jnp.asarray(f32), hp)
        jax_fused = np.asarray(jht.seg_head_fused_train(
            jnp.asarray(f32), *args, rate=rate, seed=jnp.int32(SEED),
            scale=H // f32.shape[1], interpret=True)[0])
    port = headkernels_train.seg_head_fused_train(
        torch.from_numpy(f32),
        *(torch.from_numpy(np.asarray(a)) if hasattr(a, 'shape') else a
          for a in args),
        rate=rate, seed=torch.tensor(SEED, dtype=torch.int32),
        scale=H // f32.shape[1])[0].numpy()

    assert _rel(port, jax_fused) < 2e-6
    assert _rel(port, ref) <= 1.25 * _rel(jax_fused, ref) + 1e-6
    assert 3 * _rel(jax_unfused, ref) < _rel(jax_fused, ref)
