"""The mesh's model axis (``awsegbench_torch/core/mesh.py``'s layout,
``awsegbench_torch/parallel/tensor.py``) against the JAX package's
``tp_param_shardings`` and against one rank, on the CPU.

* The layout, name for name through ``convert.flax_to_torch``, equals
  JAX's on conftest's 8-device mesh ``{'data': 4, 'model': 2}`` (shapes
  from ``jax.eval_shape``): the full-width ensemble at 64 (358 of 413
  leaves, 35.81 M of 35.98 M parameters), MiT-b1 at 64
  (tests/test_model_variants.py's case) and b0, whose stage 1 stays
  replicated. On that layout and 2 model ranks one rank's parameters and
  AdamW moments take at most 0.51 of one process's bytes.
* ``{data: 1, model: 2}``, two gloo ranks (``tests/helpers/
  torch_dist_worker.py``): the narrow ensemble of
  ``tests/test_eval.py::_TinyEnsemble``'s widths with depth heads,
  ``tp_min_features`` 8, eval forward within 2e-5 of JAX's ``apply`` on
  TP-placed parameters (tests/test_model_variants.py's tolerance) and
  within 1e-5 of the port's one rank; on rank 0 every sharded conv and
  linear layer does half of one process's FLOPs (``FlopCounterMode``).
* ``{data: 2, model: 2}``, four gloo ranks: one f32 ``TrainStep`` (AdamW,
  the clip set to bite, the MiT blocks rematerialised: the recompute
  repeats the forward's gathers) against one rank (no remat; on the CPU
  remat is bit-equal) on the same global batch and draws, at
  tests/test_torch_distributed.py's tolerances: losses 1e-6
  relative, BN statistics 1e-6, SegFormer and ensemble gradients (the
  shards concatenated) rtol 2e-3 of the leaf's scale, DeepLab's 2e-2
  relative L2; the updated parameters within 2·lr (AdamW's first step is
  ±lr where a gradient is far from 0, and its sign is noise on the
  analytically zero leaves); the replicated leaves and gradients
  bit-equal on every rank; AdamW's moments in the shapes of JAX's
  ``opt_state_shardings``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

from awsegbench.core import mesh as jmesh
from awsegbench.models.ensemble import EnsembleModel as JEnsemble
from awsegbench.models.segformer import SegFormerModel as JSegFormer
from awsegbench.models.segformer import mit_variant_config
from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.core.mesh import (DataMesh, TPMesh, has_model_axis,
                                        param_shardings, tp_param_shardings)
from awsegbench_torch.data.pipeline import draw_augment
from awsegbench_torch.models.ensemble import EnsembleModel
from awsegbench_torch.models.segformer import SegFormerModel
from awsegbench_torch.parallel.tensor import is_sharded, shard_model_
from awsegbench_torch.train.optim import create_optimizer
from awsegbench_torch.train.step import TrainStep
from awsegbench_torch.weather.corruption import draw_corruption
from helpers import torch_dist_worker as worker
from test_eval import _TinyEnsemble
from test_torch_distributed import _leaf_errors
from test_torch_models import random_variables

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NC, H, W = 5, 64, 64
TP_MIN = 8
ADAMW = {'type': 'adamw', 'learning_rate': 1e-3, 'weight_decay': 1e-4}
CLIP = 0.05       # below the step's global norm, so the clip bites

# A model axis of 2 on one process: the layout and the slicing need no
# process group.
MESH_1X2 = TPMesh(DataMesh(), DataMesh(0, 2, None, 'model'), 0, 2)


def _jax_mesh():
    return jmesh.create_mesh(jax.devices()[:8],
                             mesh_shape={'data': 4, 'model': 2})


def _jax_layout(module, x, min_features, **kwargs):
    """JAX's ``tp_param_shardings`` of ``module``'s parameters (shapes from
    ``jax.eval_shape``) as {torch name: sharded on 'model'}."""
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        jnp.zeros(x), **kwargs))['params']
    sh = jmesh.tp_param_shardings(shapes, _jax_mesh(), min_features)
    flags = jax.tree_util.tree_map(
        lambda s, p: np.full((1,) * len(p.shape),
                             float(jmesh.MODEL_AXIS in str(s.spec)),
                             np.float32),
        sh, shapes, is_leaf=lambda v: isinstance(v, NamedSharding))
    return {k: bool(v.item()) for k, v in
            flax_to_torch({'params': flags}).items()}


def _port_layout(model, min_features=64):
    return {k: v is not None for k, v in
            tp_param_shardings(model, MESH_1X2, min_features).items()}


LAYOUT_CASES = {
    'ensemble_64': (lambda: JEnsemble(num_classes=19, include_depth=True),
                    lambda: EnsembleModel(19, True), (1, 64, 128, 3)),
    'b1_64': (lambda: JSegFormer(num_classes=5, include_depth=False,
                                 hidden_sizes=mit_variant_config('b1')[0],
                                 depths=mit_variant_config('b1')[1]),
              lambda: SegFormerModel(5, False, 'faithful',
                                     *mit_variant_config('b1')),
              (1, 32, 64, 3)),
    'b0_64': (lambda: JSegFormer(num_classes=5, include_depth=False),
              lambda: SegFormerModel(5, False), (1, 32, 64, 3)),
}


@pytest.mark.parametrize('case', list(LAYOUT_CASES))
def test_layout_equals_jax_tp_param_shardings(case):
    jmodel, tmodel, x = LAYOUT_CASES[case]
    want = _jax_layout(jmodel(), x, 64, train=False)
    model = tmodel()
    got = _port_layout(model)
    assert got == want
    assert any(got.values())
    if case == 'ensemble_64':
        ps = dict(model.named_parameters())
        assert (sum(got.values()), len(got)) == (358, 413)
        n = sum(ps[k].numel() for k, s in got.items() if s)
        assert (round(n / 1e6, 2), round(sum(p.numel() for p in
                                              ps.values()) / 1e6, 2)) == (
            35.81, 35.98)
    if case == 'b0_64':   # stage 1 (32 wide) replicated, stage 4 sharded
        ps = dict(model.named_parameters())
        narrow = [k for k, p in ps.items() if p.ndim >= 2
                  and p.shape[0] == 32]
        wide = [k for k, p in ps.items() if p.ndim >= 2
                and p.shape[0] == 256]
        assert narrow and wide
        assert not any(got[k] for k in narrow)
        assert any(got[k] for k in wide)


def test_layout_functions_on_meshes():
    model = SegFormerModel(5, False)
    assert not has_model_axis(DataMesh(0, 4))
    assert has_model_axis(MESH_1X2)
    assert set(param_shardings(model, DataMesh()).values()) == {None}
    assert param_shardings(model, MESH_1X2) == tp_param_shardings(
        model, MESH_1X2)
    assert MESH_1X2.shape == {'data': 1, 'model': 2}
    assert MESH_1X2.axis_names == ('data', 'model')


def test_serving_refuses_a_sharded_model():
    from awsegbench_torch.serving import build_serving_fn
    model = SegFormerModel(5, False)
    shard_model_(model, MESH_1X2, tp_param_shardings(model, MESH_1X2))
    with pytest.raises(ValueError, match='full checkpoint'):
        build_serving_fn(model, precision='fp32')


def test_full_width_rank_bytes_at_most_051():
    """On {1, 2} at 64, one rank's parameters and AdamW moments take at
    most 0.51 of one process's bytes (≈ 0.505: the replicated leaves are
    0.17 M of 35.98 M)."""
    model = EnsembleModel(19, True)
    full = sum(p.numel() * p.element_size() for p in model.parameters())
    shard_model_(model, MESH_1X2, tp_param_shardings(model, MESH_1X2))
    assert is_sharded(model)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    local = sum(p.numel() * p.element_size() for p in model.parameters())
    moments = sum(v.numel() * v.element_size() for s in opt.state.values()
                  for v in s.values() if v.ndim)
    assert local / full <= 0.51 and moments / (2 * full) <= 0.51
    assert 0.5 < local / full


# ---------------------------------------------------------------------------
# {data: 1, model: 2}: the eval forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def variables():
    x = np.zeros((1, H, W, 3), np.float32)
    return random_variables(_TinyEnsemble(num_classes=NC, include_depth=True),
                            x, seed=7, train=False)


@pytest.fixture(scope='module')
def forward_runs(variables, tmp_path_factory):
    x = np.random.default_rng(3).standard_normal((2, H, W, 3)).astype(
        np.float32)
    payload = {'num_classes': NC, 'include_depth': True,
               'state': flax_to_torch(variables), 'x': torch.from_numpy(x),
               'shape': {'data': 1, 'model': 2}, 'tp_min_features': TP_MIN}
    ranks = worker.spawn('tp_forward', payload,
                         tmp_path_factory.mktemp('tp_forward'))
    model = _TinyEnsemble(num_classes=NC, include_depth=True)
    sh = jmesh.tp_param_shardings(variables['params'], _jax_mesh(), TP_MIN)
    placed = jax.tree_util.tree_map(jax.device_put, variables['params'], sh)
    jout = jax.jit(lambda p: model.apply(
        {'params': p, 'batch_stats': variables['batch_stats']},
        jnp.asarray(x), train=False))(placed)
    return ranks, {k: np.asarray(v) for k, v in jout.items()}


def test_forward_mesh_places_ranks(forward_runs):
    ranks, _ = forward_runs
    assert [(r['rank'], r['data'], r['model']) for r in ranks] == [
        (0, (0, 1), (0, 2)), (1, (0, 1), (1, 2))]


def test_forward_matches_jax_partitioned(forward_runs):
    ranks, jout = forward_runs
    for r in ranks:
        assert r['out'].keys() == jout.keys()
        for k, want in jout.items():
            np.testing.assert_allclose(r['out'][k].numpy(), want, rtol=2e-5,
                                       atol=2e-5, err_msg=k)


def test_forward_matches_one_rank(forward_runs):
    ranks, _ = forward_runs
    for r in ranks:
        for k, want in r['ref'].items():
            np.testing.assert_allclose(r['out'][k].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_forward_layout_matches_jax_at_8(forward_runs, variables):
    ranks, _ = forward_runs
    got = {k: v is not None for k, v in ranks[0]['layout'].items()}
    sh = jmesh.tp_param_shardings(variables['params'], _jax_mesh(), TP_MIN)
    flags = jax.tree_util.tree_map(
        lambda s, p: np.full((1,) * p.ndim, float(
            jmesh.MODEL_AXIS in str(s.spec)), np.float32),
        sh, variables['params'],
        is_leaf=lambda v: isinstance(v, NamedSharding))
    assert got == {k: bool(v.item()) for k, v in
                   flax_to_torch({'params': flags}).items()}
    full = flax_to_torch(variables)
    for name, dim in ranks[0]['layout'].items():
        shape = list(full[name].shape)
        if dim is not None:
            shape[dim] //= 2
        assert ranks[0]['local_shapes'][name] == tuple(shape), name


def test_sharded_layers_compute_half_the_flops(forward_runs):
    """Rank 0's sharded conv and linear layers run on out/2 channels: half
    of one process's FLOPs each; the replicated ones all of them. (The
    faithful heads' first convs are not called as layers: their weights go
    to the kernels' plain versions, outside these counts.)"""
    r = forward_runs[0][0]
    assert set(r['flops']) == set(r['flops_ref'])
    sharded = {n.rsplit('.', 1)[0] for n, d in r['layout'].items()
               if d is not None} & set(r['flops_ref'])   # convs, linears
    called = {n for n, ref in r['flops_ref'].items() if ref > 0}
    assert len(sharded & called) > 0.9 * len(sharded)
    for name, ref in r['flops_ref'].items():
        want = ref // 2 if name in sharded else ref
        assert r['flops'][name] == want, (name, r['flops'][name], ref)


# ---------------------------------------------------------------------------
# {data: 2, model: 2}: the train step
# ---------------------------------------------------------------------------

def _step_inputs():
    nb = 4
    rng = np.random.default_rng(11)
    labels = rng.integers(0, NC, (nb, H, W)).astype(np.int64)
    labels[:, :2] = 255
    batch = (torch.from_numpy(rng.integers(0, 256, (nb, H, W, 3),
                                           dtype=np.uint8)),
             torch.from_numpy(labels), torch.arange(nb) % 5)
    g = torch.Generator().manual_seed(12)
    seed = lambda v: torch.tensor(v, dtype=torch.int32)     # noqa: E731
    draws = {'corruption': draw_corruption(torch.zeros(nb), H, W, g),
             'augment': draw_augment(nb, g, torch.device('cpu')),
             'fog_u': torch.rand((nb, H, W), generator=g),
             'aspp_mask': torch.rand((nb, H // 16, W // 16, 256),
                                     generator=g) < 0.5,
             'seed': seed(-123456789), 'segformer_depth_seed': seed(2468),
             'deeplab_depth_seed': seed(-2 ** 31)}
    return batch, draws


@pytest.fixture(scope='module')
def step_runs(variables, tmp_path_factory):
    batch, draws = _step_inputs()
    state = flax_to_torch(variables)
    payload = {'num_classes': NC, 'state': state, 'batch': batch,
               'draws': draws, 'optimizer': ADAMW, 'grad_clip': CLIP,
               'tp_min_features': TP_MIN, 'shape': {'data': 2, 'model': 2},
               'remat': True}
    ranks = worker.spawn('tp_step', payload,
                         tmp_path_factory.mktemp('tp_step'), world=4)
    model = worker.narrow_ensemble(NC, True)
    model.load_state_dict(state)
    opt = create_optimizer(model.parameters(), ADAMW, grad_clip=CLIP)
    loss = TrainStep(model, opt, precision='fp32', device='cpu',
                     mesh=DataMesh())(*batch, draws=draws)
    one = {'loss': loss,
           'grads': {n: p.grad.clone() for n, p in model.named_parameters()},
           'params': {n: p.detach().clone()
                      for n, p in model.named_parameters()},
           'buffers': {n: b.clone() for n, b in model.named_buffers()}}
    return ranks, one


def _gathered(ranks, key):
    """Each parameter's tensor under ``key``, the model ranks' shards of
    data index 0 concatenated along the sharded dim."""
    layout = ranks[0]['layout']
    return {n: (torch.cat([ranks[0][key][n], ranks[1][key][n]], d)
                if d is not None else ranks[0][key][n])
            for n, d in layout.items()}


def test_step_mesh_places_ranks(step_runs):
    ranks, _ = step_runs
    assert [(r['rank'], r['data'], r['model']) for r in ranks] == [
        (0, (0, 2), (0, 2)), (1, (0, 2), (1, 2)),
        (2, (1, 2), (0, 2)), (3, (1, 2), (1, 2))]


def test_step_losses_equal_one_rank(step_runs):
    ranks, one = step_runs
    for r in ranks:
        for k, v in one['loss'].items():
            np.testing.assert_allclose(r['loss'][k].item(), v.item(),
                                       rtol=1e-6, err_msg=k)


def test_step_clip_bites_and_gradients_equal_one_rank(step_runs):
    ranks, one = step_runs
    got = _gathered(ranks, 'grads')
    norm = lambda gs: torch.sqrt(sum((g.double() ** 2).sum()    # noqa: E731
                                     for g in gs.values())).item()
    # the clip scaled the gradients to norm CLIP on one rank and on four
    assert norm(one['grads']) == pytest.approx(CLIP, rel=1e-5)
    assert norm(got) == pytest.approx(CLIP, rel=1e-5)
    held, dl, loud = _leaf_errors(got, one['grads'])
    assert held <= 2e-3 and not loud, (held, loud)
    assert dl <= 2e-2, dl


def test_step_bn_stats_equal_one_rank(step_runs):
    ranks, one = step_runs
    for r in ranks:
        for name, w in one['buffers'].items():
            np.testing.assert_allclose(r['buffers'][name].numpy(), w.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)


def test_step_updated_shards_equal_one_rank(step_runs):
    ranks, one = step_runs
    got = _gathered(ranks, 'params')
    lr = ADAMW['learning_rate']
    for n, want in one['params'].items():
        assert torch.equal(got[n], ranks[0]['full'][n]), n
        assert (got[n] - want).abs().max().item() <= 2 * lr, n
    moved = sum(((got[n] - w).abs() <= 1e-6).sum().item()
                for n, w in one['params'].items())
    assert moved / sum(w.numel() for w in one['params'].values()) > 0.99


def test_step_replicated_state_bit_equal_on_every_rank(step_runs):
    ranks, _ = step_runs
    r0 = ranks[0]
    for r in ranks[1:]:
        same = r['model'][0] == r0['model'][0]     # same model index
        for n, d in r0['layout'].items():
            if d is None or same:
                assert torch.equal(r['grads'][n], r0['grads'][n]), n
                assert torch.equal(r['params'][n], r0['params'][n]), n
        assert all(torch.equal(r['buffers'][n], b)
                   for n, b in r0['buffers'].items())


def test_step_moments_follow_jax_opt_state_shardings(step_runs, variables):
    ranks, _ = step_runs
    params = variables['params']
    sh = jmesh.tp_param_shardings(params, _jax_mesh(), TP_MIN)
    opt_state = jax.eval_shape(optax.adamw(1e-3).init, params)
    osh = jmesh.opt_state_shardings(opt_state, params, sh, _jax_mesh())
    mu = osh[0].mu
    flags = jax.tree_util.tree_map(
        lambda s, p: np.full((1,) * p.ndim, float(
            jmesh.MODEL_AXIS in str(s.spec)), np.float32),
        mu, params, is_leaf=lambda v: isinstance(v, NamedSharding))
    want = {k: bool(v.item()) for k, v in
            flax_to_torch({'params': flags}).items()}
    full = flax_to_torch(variables)
    for r in ranks:
        for name, shapes in r['state_shapes'].items():
            shape = list(full[name].shape)
            if want[name]:
                shape[0] //= 2
            assert shapes['exp_avg'] == shapes['exp_avg_sq'] == tuple(
                shape), name
            assert r['opt_layout'][name] == {
                'step': None, 'exp_avg': 0 if want[name] else None,
                'exp_avg_sq': 0 if want[name] else None}, name


def test_step_rank_bytes(step_runs):
    """Each rank holds its slices: parameters, gradients and moments in the
    ratio 1 : 1 : 2, below one process's parameter bytes."""
    ranks, one = step_runs
    full = sum(p.numel() * 4 for p in one['params'].values())
    for r in ranks:
        b = r['bytes']
        assert b['params'] == b['grads'] == b['moments'] // 2
        assert b['params'] < 0.55 * full
