"""The port's data mesh across two processes, over gloo on the CPU.

Each job runs in two spawned ranks (``tests/helpers/torch_dist_worker.py``:
a free localhost port, a join timeout of 110 s, a nonzero exit or a hang
fails the test) and is held against the same work on one rank in this
process, and where named against the JAX package.

* Train step (``TrainStep`` with the narrow ensemble of
  ``tests/test_eval.py::_TinyEnsemble``'s widths, plain SGD at lr 0): a
  global batch of 4 split 2 + 2, and a batch of 3 padded to 4 (the padded
  row masked out of the loss), against one rank on the same global batch
  and draws. Losses within 1e-6 relative and BN running statistics within
  1e-6 (f32 sums taken in another order); the SegFormer and ensemble
  gradients within rtol 2e-3 and 2e-3 of the leaf's largest value, the
  DeepLab member's within 2e-2 relative L2 (its f32 gradients are
  ill-conditioned at this batch, tests/test_torch_train_step.py); the two
  ranks bit-equal to each other.
* The same 2-rank step in f64 against the body of the JAX
  ``AdverseWeatherTrainer``'s train step (``prepare_batch``, fog density,
  train-mode forward, ``FogDensityAwareLoss`` with the sample mask, the
  gradient) jitted over a 2-device mesh with the batch sharded on
  ``'data'``, in f64 as tests/test_torch_train_step.py holds it: the
  loss within 1e-4 relative, every gradient within rtol 2e-3 and 2e-3 of
  the leaf's scale. JAX's draws are fed to the port; its ``nn.Dropout``
  calls get the counter-hash masks of the port's seeds over the global
  batch (``flax.linen.intercept_methods``, test code only).
* The ``Evaluator`` sweep (histogram, exact and exact-host AUROC, and
  with spatial tiling) on two batches of 3 images: the confusion
  matrices and the AUROC histogram equal to one rank's, ECE within 1e-6,
  the exact AUROC within 1e-12.
* ``tiled_forward`` with its 4 tiles split 2 + 2 against one rank: within
  1e-5 (the tiles' convolutions run at another batch size).
* The collectives, the mesh, the loader's process slicing (against JAX's
  ``BatchIterator(process_count=2)``), ``auroc_exact_sharded`` (against
  the JAX package's on a 2-device mesh), a halo resync over the ranks,
  and the loss's global means with fog from the predicted depth (its min,
  max and edge mean over both ranks' rows).
* The train and evaluate CLIs as ``torchrun --nproc_per_node 2`` starts
  them (the rank, world and address in the environment), on the CPU.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from awsegbench.core.mesh import create_mesh as jcreate_mesh
from awsegbench.data.pipeline import BatchIterator as JBatchIterator
from awsegbench.losses.fog_density import FogDensityAwareLoss as JLoss
from awsegbench.metrics.disagreement import \
    auroc_exact_sharded as jauroc_sharded
from awsegbench.ops import headkernels_train as jht
from awsegbench.train.trainer import fog_density_from_weather as jfog
from awsegbench_torch.convert import flax_to_torch, torch_to_flax
from awsegbench_torch.core.mesh import DataMesh
from awsegbench_torch.data.pipeline import draw_augment
from awsegbench_torch.metrics.disagreement import auroc_exact
from awsegbench_torch.parallel.collectives import TileInfo, spatial_tiles
from awsegbench_torch.weather.corruption import draw_corruption
from helpers import torch_dist_worker as worker
from test_eval import _TinyEnsemble
from test_torch_models import random_variables
from test_torch_train_step import _flat
from test_torch_train_step_depth import _jax_prepare
from test_torch_weather import _jax_draws

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NC, H, W = 5, 64, 64
SEEDS = {'seed': -123456789, 'segformer_depth_seed': 24681357,
         'deeplab_depth_seed': -2 ** 31}
# each nn.Dropout of the JAX model, by module path → the port's draw
DROPOUTS = {('segformer', 'SegmentationHead_0'): 'seed',
            ('segformer', 'DepthEstimationHead_0'): 'segformer_depth_seed',
            ('deeplabv3plus', 'DepthEstimationHead_0'): 'deeplab_depth_seed',
            ('deeplabv3plus', 'ASPP_0'): 'aspp_mask'}


@pytest.fixture(scope='module')
def variables():
    """The narrow ensemble's weights (with depth heads), JAX's layout."""
    x = np.zeros((1, H, W, 3), np.float32)
    return random_variables(_TinyEnsemble(num_classes=NC, include_depth=True),
                            x, seed=5, train=False)


def _state(variables, include_depth):
    sd = flax_to_torch(variables)
    return {k: v for k, v in sd.items()
            if include_depth or 'DepthEstimationHead' not in k}


def _batch(seed, b, h=H, w=W):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NC, (b, h, w)).astype(np.int32)
    labels[:, :2] = 255                                  # ignored rows
    return (torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                          dtype=np.uint8)),
            torch.from_numpy(labels),
            torch.from_numpy((np.arange(b) % 5).astype(np.int32)))


def _torch_draws(nb, include_depth, seed):
    g = torch.Generator().manual_seed(seed)
    d = {'corruption': draw_corruption(torch.zeros(nb), H, W, g),
         'augment': draw_augment(nb, g, torch.device('cpu')),
         'fog_u': torch.rand((nb, H, W), generator=g),
         'aspp_mask': torch.rand((nb, H // 16, W // 16, 256),
                                 generator=g) < 0.5}
    for k, v in SEEDS.items():
        if include_depth or k == 'seed':
            d[k] = torch.tensor(v, dtype=torch.int32)
    return d


def _padded(case):
    """The one-rank reference of a padded case: the batch padded by
    repeating its last row, and the sample mask."""
    case = dict(case)
    b = case['batch'][0].shape[0]
    nb = case['draws']['fog_u'].shape[0]
    case['batch'] = tuple(torch.cat([t, t[-1:].expand(nb - b, *t.shape[1:])])
                          for t in case['batch'])
    case['sample_mask'] = (torch.arange(nb) < b).float()
    return case


def _jax_reference(variables, images, labels, wids):
    """JAX's 2-device step on the padded global batch in f64, and the
    draws it took, for the port."""
    b = images.shape[0]
    nb = b + (-b) % 2
    pad = lambda a: np.concatenate([a, np.repeat(a[-1:], nb - b, 0)])  # noqa
    images, labels, wids = (pad(np.asarray(t)) for t in (images, labels,
                                                         wids))
    # JAX pads the sample ids by repeating the last, so the padded row
    # takes the last row's corruption keys
    keys = jax.random.split(jax.random.PRNGKey(8), b)
    keys = jnp.concatenate([keys, jnp.repeat(keys[-1:], nb - b, 0)])
    aug_key, fog_key = jax.random.PRNGKey(9), jax.random.PRNGKey(10)
    rng = np.random.default_rng(12)
    masks = {'aspp_mask': rng.random((nb, H // 16, W // 16, 256)) < 0.5}
    for name, shape in (('seed', (nb, H, W, 256)),
                        ('segformer_depth_seed', (nb, H, W, 128)),
                        ('deeplab_depth_seed', (nb, H // 16, W // 16, 256))):
        masks[name] = np.asarray(jht.dropout_keep_mask(
            shape, jnp.int32(SEEDS[name]), 0.1))
    sample_mask = (np.arange(nb) < b).astype(np.float32)
    jmodel = _TinyEnsemble(num_classes=NC, include_depth=True)

    def dropout(next_fun, args, kwargs, context):
        if not (isinstance(context.module, fnn.Dropout)
                and context.method_name == '__call__'):
            return next_fun(*args, **kwargs)
        x, rate = args[0], context.module.rate
        mask = masks[DROPOUTS[context.module.scope.path[:2]]]
        assert mask.shape == x.shape
        return jnp.where(jnp.asarray(mask), x / (1.0 - rate), 0.0)

    def loss_of(p, bs, image, targets, fog, mask):
        with fnn.intercept_methods(dropout):
            out, _ = jmodel.apply({'params': p, 'batch_stats': bs}, image,
                                  train=True, mutable=['batch_stats'])
        out = {k: o.astype(jnp.float32) for k, o in out.items()}
        return JLoss()(out, targets, fog, sample_mask=mask)['total_loss']

    mesh = jcreate_mesh(jax.devices()[:2])
    data, rep = NamedSharding(mesh, P('data')), NamedSharding(mesh, P())
    with jax.default_matmul_precision('float32'):
        prep = _jax_prepare(jnp.asarray(images), jnp.asarray(labels),
                            jnp.asarray(wids), keys, aug_key)
        fog = jfog(jnp.asarray(wids), fog_key, H, W)
        with jax.enable_x64(True):
            f64 = lambda t: jax.tree_util.tree_map(          # noqa: E731
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
            step = jax.jit(jax.value_and_grad(loss_of),
                           in_shardings=(rep, rep, data, data, data, data),
                           out_shardings=rep)
            loss, grads = step(
                f64(variables['params']), f64(variables['batch_stats']),
                f64(prep['image']), {'label': prep['label'],
                                     'depth': f64(prep['depth'])},
                f64(fog), jnp.asarray(sample_mask))
    to_t = lambda x: torch.from_numpy(np.array(x))           # noqa: E731
    draws = {'corruption': _jax_draws(keys, H, W),
             'augment': {k: to_t(v) for k, v in
                         _jax_aug_draws_n(aug_key, nb).items()},
             'fog_u': to_t(jax.random.uniform(fog_key, (nb, H, W))),
             'aspp_mask': torch.from_numpy(masks['aspp_mask']),
             **{k: torch.tensor(v, dtype=torch.int32)
                for k, v in SEEDS.items()}}
    return float(loss), dict(_flat(jax.device_get(grads))), draws


def _jax_aug_draws_n(key, n):
    """``_train_augment``'s draws for a batch of ``n``, as it makes them."""
    k_flip, k_do_bc, k_alpha, k_beta = jax.random.split(key, 4)
    return {'do_flip': jax.random.bernoulli(k_flip, 0.5, (n,)),
            'do_bc': jax.random.bernoulli(k_do_bc, 0.3, (n,)),
            'alpha': 1.0 + jax.random.uniform(k_alpha, (n,), minval=-0.2,
                                              maxval=0.2),
            'beta': jax.random.uniform(k_beta, (n,), minval=-0.2,
                                       maxval=0.2)}


@pytest.fixture(scope='module')
def train_runs(variables, tmp_path_factory):
    """Two ranks' train steps, one rank's, and JAX's 2-device step."""
    even = {'state': _state(variables, True), 'include_depth': True,
            'dtype': 'float32', 'batch': _batch(1, 4),
            'draws': _torch_draws(4, True, 2)}
    padded = {'state': _state(variables, False), 'include_depth': False,
              'dtype': 'float32', 'batch': _batch(3, 3),
              'draws': _torch_draws(4, False, 4)}
    batch = _batch(5, 3)
    jloss, jgrads, jdraws = _jax_reference(variables, *batch)
    jax_case = {'state': _state(variables, True), 'include_depth': True,
                'dtype': 'float64', 'batch': batch, 'draws': jdraws}
    cases = {'even': even, 'padded': padded, 'jax_f64': jax_case}
    ranks = worker.spawn('train', list(cases.values()),
                         tmp_path_factory.mktemp('train'))
    one = {'even': worker.train_case(even, DataMesh()),
           'padded': worker.train_case(_padded(padded), DataMesh())}
    two = {name: [r[i] for r in ranks] for i, name in enumerate(cases)}
    return {'two': two, 'one': one, 'jloss': jloss, 'jgrads': jgrads}


def _leaf_errors(got, want):
    """(worst excess over rtol 2e-3 per leaf scale of the SegFormer and
    ensemble leaves, worst DeepLab relative L2, negligible-leaf offenders)
    of gradients by name; leaves below 1e-6 of the largest scale are
    analytically zero and must stay negligible."""
    top = max(t.abs().max().item() for t in want.values())
    held = dl = 0.0
    loud = []
    for name, w in want.items():
        g, scale = got[name], w.abs().max().item()
        if scale < 1e-6 * top:
            if g.abs().max().item() >= 1e-6 * top:
                loud.append(name)
            continue
        if name.startswith(('deeplabv3plus', 'deeplabv3plus/')):
            dl = max(dl, ((g - w).norm() / w.norm()).item())
            continue
        held = max(held, ((g - w).abs() - 2e-3 * w.abs()).max().item()
                   / scale)
    return held, dl, loud


@pytest.mark.parametrize('case', ['even', 'padded'])
def test_two_rank_losses_equal_one_rank(train_runs, case):
    want = train_runs['one'][case][0]
    for loss, *_ in train_runs['two'][case]:
        for k, v in want.items():
            # f32 sums of the global batch taken in another order
            np.testing.assert_allclose(loss[k].item(), v.item(), rtol=1e-6,
                                       err_msg=k)
    assert want['total_loss'].item() > 0


@pytest.mark.parametrize('case', ['even', 'padded'])
def test_two_rank_gradients_equal_one_rank(train_runs, case):
    want = train_runs['one'][case][1]
    for _, grads, *_ in train_runs['two'][case]:
        assert grads.keys() == want.keys()
        held, dl, loud = _leaf_errors(grads, want)
        assert held <= 2e-3 and not loud, (held, loud)
        assert dl <= 2e-2, dl         # the DeepLab member, relative L2


@pytest.mark.parametrize('case', ['even', 'padded'])
def test_two_rank_bn_stats_equal_one_rank(train_runs, case):
    """BN's running statistics from the global batch's statistics (the
    padded row counts, as in JAX)."""
    want = train_runs['one'][case][2]
    for _, _, buffers, _ in train_runs['two'][case]:
        for name, w in want.items():
            np.testing.assert_allclose(buffers[name].numpy(), w.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize('case', ['even', 'padded', 'jax_f64'])
def test_ranks_hold_identical_state(train_runs, case):
    """After the gradient all-reduce both ranks hold the same loss,
    gradients and BN statistics, bit for bit."""
    (l0, g0, b0, _), (l1, g1, b1, _) = train_runs['two'][case]
    assert all(torch.equal(l0[k], l1[k]) for k in l0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(b0[k], b1[k]) for k in b0)


def test_two_rank_step_loss_matches_jax_two_devices(train_runs):
    for loss, *_ in train_runs['two']['jax_f64']:
        np.testing.assert_allclose(loss['total_loss'].item(),
                                   train_runs['jloss'], rtol=1e-4)


def test_two_rank_step_gradients_match_jax_two_devices_f64(train_runs):
    """Every leaf, the DeepLab member's included, in f64."""
    jgrads = train_runs['jgrads']
    _, grads, _, _ = train_runs['two']['jax_f64'][0]
    got = dict(_flat(torch_to_flax(grads)['params']))
    assert got.keys() == jgrads.keys()
    got = {k: torch.from_numpy(np.array(v)) for k, v in got.items()}
    want = {k: torch.from_numpy(np.array(v)) for k, v in jgrads.items()}
    top = max(t.abs().max().item() for t in want.values())
    for name, w in want.items():
        g, scale = got[name], w.abs().max().item()
        if scale < 1e-6 * top:                     # analytically zero
            assert g.abs().max().item() < 1e-6 * top, name
            continue
        excess = ((g - w).abs() - 2e-3 * w.abs()).max().item() / scale
        assert excess <= 2e-3, (name, excess)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

SWEEP_MODES = ('histogram', 'exact', 'exact_host', 'tiled')


@pytest.fixture(scope='module')
def sweep_runs(variables, tmp_path_factory):
    batches = []
    for i in range(2):
        images, labels, wids = _batch(20 + i, 3, 192, 192)
        batches.append({'image': images.numpy(), 'label': labels.numpy(),
                        'weather_id': ((wids + i) % 5).numpy(),
                        'sample_id': np.arange(3 * i, 3 * i + 3)})
    base = {'model': {'num_classes': NC}, 'tpu': {'precision': 'fp32'}}
    configs = {m: dict(base, evaluation={'auroc_mode': m})
               for m in SWEEP_MODES[:3]}
    configs['tiled'] = dict(base, evaluation={
        'auroc_mode': 'exact', 'spatial_tiling': 'on',
        'tile_size': [96, 96], 'tile_halo': 32})
    payload = {'num_classes': NC, 'state': _state(variables, False),
               'batches': batches, 'configs': configs}
    ranks = worker.spawn('sweep', payload, tmp_path_factory.mktemp('sweep'))
    return ranks, worker.sweep_job(payload, DataMesh())


@pytest.mark.parametrize('mode', SWEEP_MODES)
def test_two_rank_sweep_counts_equal_one_rank(sweep_runs, mode):
    ranks, one = sweep_runs
    res1, acc1 = one[mode]
    for res, acc in (r[mode] for r in ranks):
        assert torch.equal(acc['cm'], acc1['cm'])
        assert torch.equal(acc['auroc_hist'], acc1['auroc_hist'])
        assert res['_num_images'] == res1['_num_images'] == 6
        assert res.keys() == res1.keys()
    # every real pixel counted once: the padded rows are masked out
    labels = acc1['cm'].sum()
    assert labels > 0


@pytest.mark.parametrize('mode', SWEEP_MODES)
def test_two_rank_sweep_metrics_equal_one_rank(sweep_runs, mode):
    ranks, one = sweep_runs
    res1, _ = one[mode]
    for res, _ in (r[mode] for r in ranks):
        assert abs(res['expected_calibration_error']
                   - res1['expected_calibration_error']) <= 1e-6
        assert res['overall_miou'] == res1['overall_miou']
        # the exact AUROC sorts the same pixels: equal to f64 rounding
        assert abs(res['ensemble_disagreement_auroc']
                   - res1['ensemble_disagreement_auroc']) <= 1e-12


# ---------------------------------------------------------------------------
# tiles over two ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tile_runs(variables, tmp_path_factory):
    img = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (384, 384, 3)).astype(np.float32))
    payload = {'num_classes': NC, 'include_depth': True,
               'state': _state(variables, True), 'image': img,
               'tile': (192, 192, 64)}
    ranks = worker.spawn('tiles', payload, tmp_path_factory.mktemp('tiles'))
    return ranks, worker.tiles_job(payload, DataMesh())


def test_tiles_over_two_ranks_equal_one_rank(tile_runs):
    ranks, one = tile_runs
    assert [(r['rank'], r['size']) for r in ranks] == [(0, 2), (1, 2)]
    for r in ranks:
        assert r['tiled'].keys() == one['tiled'].keys()
        for k, v in one['tiled'].items():
            # the same tiles at batch 2 instead of 4
            torch.testing.assert_close(r['tiled'][k], v, rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# collectives, the mesh, the loader, the sharded AUROC, the loss's means
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def coll_runs(tmp_path_factory):
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.standard_normal((64, 64, 4)).astype(
        np.float32))
    info = TileInfo.build((64, 64), (32, 32), 8)
    core = torch.zeros((4, 48, 48, 4), dtype=torch.bool)
    for i, (y, x, sy, sx) in enumerate(info.origins):
        core[i, y - sy:y - sy + 32, x - sx:x - sx + 32] = True
    depth = torch.from_numpy(np.round(rng.random((4, 8, 8, 1)), 1)
                             .astype(np.float32))          # ties at 0 and 1
    loss = {'seg': torch.from_numpy(rng.standard_normal((4, 8, 8, NC))
                                    .astype(np.float32)),
            'depth': depth,
            'label': torch.from_numpy(rng.integers(0, NC, (4, 8, 8))),
            'target': torch.from_numpy(rng.random((4, 8, 8)).astype(
                np.float32)),
            'mask': torch.tensor([1.0, 1.0, 1.0, 0.0])}
    payload = {'dataset': worker.ToyDataset(18), 'image': img, 'core': core,
               'loss': loss}
    ranks = worker.spawn('collectives', payload,
                         tmp_path_factory.mktemp('coll'))
    return ranks, payload


def test_mesh_over_the_world(coll_runs):
    ranks, _ = coll_runs
    for r, res in enumerate(ranks):
        assert (res['rank'], res['size'], res['mesh_dict']) == (r, 2, 2)
        assert 'needs 1 devices, have 2' in res['mesh_1']
        assert 'needs 4 devices, have 2' in res['mesh_4']
        assert res['rows'] == (6, 3 * r)


def test_psum_and_pmean_tree(coll_runs):
    ranks, _ = coll_runs
    for res in ranks:
        assert torch.equal(res['psum']['i'], torch.arange(4) * 3)
        assert res['psum']['i'].dtype == torch.int64
        assert torch.equal(res['psum']['f'], torch.full((2, 3), 3.0,
                                                        dtype=torch.float64))
        assert torch.equal(res['pmean']['f'], torch.full(
            (2, 3), 1.5, dtype=torch.float64))


def test_all_gather_batch_and_varlen(coll_runs):
    ranks, _ = coll_runs
    for res in ranks:
        assert torch.equal(res['gather'], torch.tensor(
            [[0.0, 0.0], [0.0, 0.0], [1.0, 1.0], [1.0, 1.0]]))
        assert torch.equal(res['varlen'], torch.tensor(
            [0.0, 1.0, 0.0, 1.0, 2.0]))


def test_sync_sum_gradient_is_the_global_one(coll_runs):
    """Each rank backprops its share s²/2 of the global s² with s = Σ x²
    over both ranks' x: the gradient on each rank's x is the global
    loss's, 2s·2x."""
    ranks, _ = coll_runs
    s = sum(((torch.tensor([1.0, 2.0, 3.0]) * (r + 1)) ** 2).sum()
            for r in range(2))
    for r, res in enumerate(ranks):
        x = torch.tensor([1.0, 2.0, 3.0]) * (r + 1)
        assert res['sync_value'].item() == s.item()
        torch.testing.assert_close(res['sync_grad'], 2 * s * 2 * x)


def test_replicate_and_shard_batch(coll_runs):
    ranks, _ = coll_runs
    for r, res in enumerate(ranks):
        assert torch.equal(res['replicated'], torch.full((2, 3), 7.0))
        np.testing.assert_array_equal(res['shard'], np.arange(4 * r,
                                                              4 * r + 4))


def test_loader_reads_the_group_as_jax_slices(coll_runs):
    """``create_dataloader`` under a group of 2 takes rank and size from
    it, and each rank's batches are JAX's ``BatchIterator`` slices."""
    ranks, payload = coll_runs
    for r, res in enumerate(ranks):
        assert res['loader'][0] == (r, 2)
        jit = JBatchIterator(payload['dataset'], batch_size=4, shuffle=True,
                             seed=3, num_threads=1, process_index=r,
                             process_count=2)
        assert res['loader'][1] == [b['sample_id'].tolist() for b in jit]


def test_auroc_exact_sharded_matches_jax(coll_runs):
    """Buffers of 50 and 67 entries (ties, dropped entries) on the two
    ranks: the same value on both, equal to ``auroc_exact`` of their
    concatenation and to JAX's ``auroc_exact_sharded`` on a 2-device
    mesh."""
    ranks, _ = coll_runs
    s, lab, w = (torch.cat([res['auroc'][i] for res in ranks])
                 for i in range(3))
    want = auroc_exact(s, lab, w).item()
    n = s.numel() // 2 * 2               # JAX's buffer divides the mesh
    jmesh = jcreate_mesh(jax.devices()[:2])
    jwant = float(jauroc_sharded(jnp.asarray(s[:n].numpy()),
                                 jnp.asarray(lab[:n].numpy()),
                                 jnp.asarray(w[:n].numpy()), jmesh))
    assert abs(auroc_exact(s[:n], lab[:n], w[:n]).item() - jwant) <= 1e-6
    for res in ranks:
        assert abs(res['auroc'][3].item() - want) <= 1e-12


def test_resync_over_two_ranks_refills_halo(coll_runs):
    """JAX's halo-corruption test with the 4 tiles split 2 + 2: every
    rank's halos refilled from the other rank's cores."""
    ranks, payload = coll_runs
    tiles = spatial_tiles(payload['image'], 32, 32, 8)
    for r, res in enumerate(ranks):
        torch.testing.assert_close(res['resync'], tiles[2 * r:2 * r + 2],
                                   rtol=0, atol=0)


def test_loss_global_means_with_fog_from_depth(coll_runs):
    """The fog-density-aware loss with fog from the predicted depth over
    rows split 2 + 2 (one padded row masked): the loss equals one rank's
    within 1e-6, and the gradients on each rank's rows within 1e-6 (the
    depth's min and max tie at 0 and 1 on both ranks: their gradient
    splits evenly over every tied pixel, as ``Tensor.min`` does)."""
    ranks, payload = coll_runs
    want, gseg, gdepth = worker.loss_case(payload['loss'])
    for r, res in enumerate(ranks):
        loss, seg, depth = res['loss']
        for k, v in want.items():
            np.testing.assert_allclose(loss[k].item(), v.item(), rtol=1e-6)
        torch.testing.assert_close(seg, gseg[2 * r:2 * r + 2], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(depth, gdepth[2 * r:2 * r + 2],
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the CLIs under a torchrun-style environment
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('cli')
    cfg = tmp / 'tiny.yaml'
    cfg.write_text(
        'model: {type: segformer, num_classes: 5, pretrained: false}\n'
        'data: {data_root: /nonexistent, image_size: [32, 64]}\n'
        'training: {batch_size: 4, epochs: 1, num_workers: 1}\n'
        'optimizer: {learning_rate: 0.001}\nmlflow: {enabled: false}\n'
        "logging: {level: WARNING, progress_bar: false}\n"
        'tpu: {mesh_shape: {data: 2}}\n')
    payload = {'config': str(cfg), 'out': str(tmp / 'run'),
               'port': worker.free_port(), 'port2': worker.free_port()}
    return worker.spawn('cli', payload, tmp / 'spawn'), tmp / 'run'


def test_cli_ranks_train_one_model(cli_runs):
    """Both ranks end the epoch with the same weights, the train loader
    giving each its rows of every global batch."""
    ranks, _ = cli_runs
    assert [(r['rank'], r['size']) for r in ranks] == [(0, 2), (1, 2)]
    assert [r['train_loader'] for r in ranks] == [(0, 2), (1, 2)]
    s0, s1 = ranks[0]['state'], ranks[1]['state']
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_cli_rank0_writes_checkpoint_and_results(cli_runs):
    ranks, out = cli_runs
    latest = torch.load(out / 'checkpoints' / 'latest' / 'model.pt',
                        weights_only=False)['state_dict']
    assert all(torch.equal(latest[k], v) for k, v in
               ranks[0]['state'].items())
    results = out / 'results' / 'training_results.json'
    assert results.is_file() and (out / 'eval'
                                  / 'evaluation_results.json').is_file()


def test_cli_evaluate_ranks_agree(cli_runs):
    ranks, _ = cli_runs
    e0, e1 = ranks[0]['eval'], ranks[1]['eval']
    keys = {k for k in e0 if not k.startswith('_')}
    assert keys == {k for k in e1 if not k.startswith('_')}
    assert 'overall_miou' in keys
    assert all(e0[k] == e1[k] for k in keys)
    assert e0['_num_images'] == 20
