"""The port's models (``awsegbench_torch/models``) against the JAX package on
the CPU, with the same weights carried over by ``convert.flax_to_torch``.

JAX variables come from ``jax.eval_shape(model.init, ...)`` shapes filled
with seeded numpy values (``init`` itself compiles for most of a minute on
the CPU). Tolerances: encoder stage features < 2e-4 and ensemble logits
≤ 2e-3, the JAX package's own parity tolerances for those levels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.models import deeplab as jdeeplab
from awsegbench.models import ensemble as jensemble
from awsegbench.models import factory as jfactory
from awsegbench.models import segformer as jsegformer
from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.models import count_parameters, create_model
from awsegbench_torch.models.deeplab import DeepLabV3PlusModel
from awsegbench_torch.models.ensemble import EnsembleModel
from awsegbench_torch.models.segformer import MiTEncoder, SegFormerModel

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def random_variables(module, x, seed=0, **kwargs):
    """Seeded numpy values in the shapes of ``module.init``'s variables,
    scaled so activations stay O(1) (kernels ~ 1/sqrt(fan_in), BN var > 0,
    residual-branch BN scales small)."""
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        jnp.asarray(x), **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        names = [str(getattr(p, 'key', p)) for p in path]
        leaf, shape = names[-1], s.shape
        if leaf == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif leaf == 'var':
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == 'scale':
            branch_end = 'Bottleneck' in names[-3] and names[-2] == 'BatchNorm_0'
            v = rng.uniform(0.1, 0.3, shape) if branch_end else \
                rng.uniform(0.6, 1.2, shape)
        elif leaf == 'temperature':
            v = rng.uniform(0.8, 1.2, shape)
        elif leaf == 'ensemble_weights':
            v = 0.5 + rng.standard_normal(shape) * 0.2
        else:                                    # bias, mean
            v = rng.standard_normal(shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load(torch_module, variables):
    torch_module.load_state_dict(flax_to_torch(variables), strict=True)
    return torch_module.eval()


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.fixture(autouse=True)
def _f32_matmul():
    with jax.default_matmul_precision('float32'):
        yield


@pytest.fixture(scope='module')
def ensemble():
    """B0 + R50 ensemble at 64×128 f32: JAX outputs (one jitted program
    with the forward and the disagreement map) and the converted port."""
    x = np.random.default_rng(1).standard_normal((2, 64, 128, 3)).astype(
        np.float32)
    jmodel = jensemble.EnsembleModel(num_classes=19, include_depth=True,
                                     head_mode='faithful')
    variables = random_variables(jmodel, x[:1], train=False)

    def both(module, x):
        return module(x, train=False), module.get_ensemble_disagreement(x)

    with jax.default_matmul_precision('float32'):
        out, dis = jax.jit(lambda v, x: jmodel.apply(v, x, method=both))(
            variables, jnp.asarray(x))
    model = load(EnsembleModel(num_classes=19, include_depth=True,
                               head_mode='faithful'), variables)
    return x, variables, jax.device_get(out), np.asarray(dis), model


def test_converter_consumes_every_leaf(ensemble):
    _, variables, _, _, model = ensemble
    sd = flax_to_torch(variables)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves
    assert set(sd) == set(model.state_dict())
    assert count_parameters(model) == jfactory.count_parameters(
        variables['params'])


def test_converter_layouts(ensemble):
    _, variables, _, _, _ = ensemble
    sd = flax_to_torch(variables)
    seg = variables['params']['segformer']['MiTEncoder_0']
    blk = seg['SegFormerBlock_0']
    np.testing.assert_array_equal(
        sd['segformer.MiTEncoder_0.SegFormerBlock_0.EfficientSelfAttention_0'
           '.Dense_0.weight'].numpy(),
        blk['EfficientSelfAttention_0']['Dense_0']['kernel'].T)
    dw = blk['MixFFN_0']['Conv_0']['kernel']                 # (3, 3, 1, C)
    got = sd['segformer.MiTEncoder_0.SegFormerBlock_0.MixFFN_0.Conv_0.weight']
    assert got.shape == (dw.shape[3], 1, 3, 3)
    np.testing.assert_array_equal(got[5, 0].numpy(), dw[:, :, 0, 5])
    stem = variables['params']['deeplabv3plus']['ResNetEncoder_0']
    got = sd['deeplabv3plus.ResNetEncoder_0.Conv_0.weight']
    np.testing.assert_array_equal(got[7, 2].numpy(),
                                  stem['Conv_0']['kernel'][:, :, 2, 7])
    bn = variables['batch_stats']['deeplabv3plus']['ResNetEncoder_0']
    np.testing.assert_array_equal(
        sd['deeplabv3plus.ResNetEncoder_0.BatchNorm_0.running_var'].numpy(),
        bn['BatchNorm_0']['var'])


def test_full_ensemble_logits(ensemble):
    x, _, want, _, model = ensemble
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want)
    for key in ('segformer_seg', 'deeplabv3plus_seg', 'segmentation'):
        assert got[key].shape == (2, 64, 128, 19)
        assert np.abs(np.asarray(want[key])).max() > 0.5   # not a trivial map
        _close(got[key], want[key], 2e-3)
    for key in ('depth', 'segformer_depth', 'deeplabv3plus_depth'):
        _close(got[key], want[key], 2e-3)


def test_disagreement_keeps_the_reversed_kl(ensemble):
    x, _, _, want, model = ensemble
    with torch.no_grad():
        got = model.get_ensemble_disagreement(torch.from_numpy(x))
    assert got.shape == (2, 64, 128)
    _close(got, want, 2e-3)


def test_ensemble_strategies(ensemble):
    x, _, _, _, model = ensemble
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        s1, s2 = out['segformer_seg'], out['deeplabv3plus_seg']
        t = model.temperature
        for strategy in ('max_confidence', 'average'):
            model.ensemble_strategy = strategy
            got = model(torch.from_numpy(x))['segmentation']
            if strategy == 'average':
                want = (s1 + s2) / 2.0 / t
            else:
                pick = (torch.softmax(s1, -1).amax(-1, keepdim=True)
                        > torch.softmax(s2, -1).amax(-1, keepdim=True))
                want = torch.where(pick, s1, s2) / t
            _close(got, want.numpy(), 1e-6)
        model.ensemble_strategy = 'weighted_average'


def test_mit_encoder_features_narrow():
    x = np.random.default_rng(2).standard_normal((2, 64, 96, 3)).astype(
        np.float32)
    kw = dict(hidden_sizes=(8, 16, 40, 64), depths=(1, 1, 1, 1))
    jmodel = jsegformer.MiTEncoder(**kw)
    variables = random_variables(jmodel, x)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = load(MiTEncoder(**kw), variables)(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() < 2e-4


@pytest.mark.parametrize('head_mode,size', [
    ('faithful', (64, 96)), ('fused', (64, 96)),
    # 80 rows give 3 feature rows: no integer ×scale, so the faithful heads
    # take the materialised upsample
    ('faithful', (80, 96))])
def test_segformer_narrow(head_mode, size):
    x = np.random.default_rng(3).standard_normal((1, *size, 3)).astype(
        np.float32)
    kw = dict(num_classes=19, include_depth=True, head_mode=head_mode,
              hidden_sizes=(8, 16, 40, 64), depths=(1, 1, 1, 1))
    jmodel = jsegformer.SegFormerModel(**kw)
    variables = random_variables(jmodel, x, train=False)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = load(SegFormerModel(**kw), variables)(torch.from_numpy(x))
    for key in ('segmentation', 'depth'):
        assert got[key].shape == want[key].shape
        _close(got[key], want[key], 1e-4)


def test_deeplab_narrow():
    x = np.random.default_rng(4).standard_normal((2, 64, 96, 3)).astype(
        np.float32)
    kw = dict(num_classes=5, include_depth=True, encoder_layers=(1, 1, 1, 1))
    jmodel = jdeeplab.DeepLabV3PlusModel(**kw)
    variables = random_variables(jmodel, x, train=False)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = load(DeepLabV3PlusModel(**kw), variables)(torch.from_numpy(x))
    for key in ('segmentation', 'depth'):
        assert got[key].shape == want[key].shape
        _close(got[key], want[key], 1e-4)


def test_create_model_needs_a_card_unless_cpu():
    cfg = {'type': 'segformer', 'num_classes': 19, 'include_depth': False}
    model = create_model(cfg, device='cpu')
    assert not model.training
    assert next(model.parameters()).device.type == 'cpu'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            create_model(cfg)


def test_create_model_rejects_unfused_upsample():
    cfg = {'type': 'segformer', 'include_depth': False}
    create_model({**cfg, 'fused_upsample': True}, device='cpu')
    with pytest.raises(ValueError, match='fused_upsample'):
        create_model({**cfg, 'fused_upsample': False}, device='cpu')
