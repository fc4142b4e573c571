"""The port's data mesh and spatial tiling (``awsegbench_torch/core/mesh.py``,
``awsegbench_torch/parallel/collectives.py``) against the JAX package's, in
one process on the CPU. Two ranks are held in
tests/test_torch_distributed.py.

* The tile geometry (``tile_grid``, ``TileInfo.build``, ``scaled``,
  ``scale_for``, ``choose_tile_grid``) and ``pad_batch_to_multiple``
  equal JAX's, over ``hypothesis`` shapes; ``spatial_tiles``,
  ``stitch_tiles``, ``assemble_full``, ``extract_tiles`` and ``resync``
  equal JAX's bit for bit (they only move values).
* ``tiled_forward`` with ``tile_info`` on the narrow ensemble of
  ``tests/test_eval.py::_TinyEnsemble``'s widths at 384×384, 192-pixel
  tiles and a 64-pixel halo, on converted weights: within rtol 2e-4 and
  atol 2e-5 of JAX's tiled forward and of the port's monolithic forward,
  argmax equal (JAX's own tiled-against-monolithic tolerance,
  tests/test_parallel.py).
* The ``Evaluator`` with ``spatial_tiling='on'`` against ``'off'``: equal
  metrics for a pure-conv model (halo-exact), and for the narrow ensemble
  equal confusion matrices, ECE and AUROC within 1e-6.
* ``auroc_exact_sharded`` on one rank against JAX's on a 2-device mesh,
  the loader's process slicing against JAX's ``BatchIterator``, the
  config check, the single-process mesh, and the dropout hash's row
  offset (a rank's rows hash as the global batch's).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import awsegbench.parallel as jparallel
from awsegbench.core import mesh as jmesh
from awsegbench.data.pipeline import BatchIterator as JBatchIterator
from awsegbench.metrics.disagreement import \
    auroc_exact_sharded as jauroc_sharded
from awsegbench.ops import headkernels_train as jht
from awsegbench.parallel import collectives as jcol
from awsegbench_torch import parallel
from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.core import mesh
from awsegbench_torch.data.pipeline import BatchIterator, create_dataloader
from awsegbench_torch.eval.evaluator import Evaluator
from awsegbench_torch.metrics.disagreement import (auroc_exact,
                                                   auroc_exact_sharded)
from awsegbench_torch.models.heads import rank_seed
from awsegbench_torch.ops.headkernels_train import dropout_keep_mask
from awsegbench_torch.parallel import collectives as col
from awsegbench_torch.train.step import TrainStep
from awsegbench_torch.train.trainer import AdverseWeatherTrainer
from awsegbench_torch.utils.config import check_tpu_section
from helpers.torch_dist_worker import ToyDataset, narrow_ensemble
from test_eval import _TinyEnsemble
from test_torch_models import random_variables

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NC = 5


def _info(t):
    return (t.image_hw, t.tile_hw, t.halo, t.origins)


@st.composite
def geometries(draw, unit=1):
    """(image_hw, tile_hw, halo) with the tiles dividing the image and
    tile + 2·halo inside it; every value a multiple of ``unit``."""
    th, tw = (unit * draw(st.integers(1, 6)) for _ in range(2))
    gh, gw = draw(st.integers(1, 4)), draw(st.integers(1, 4))
    h, w = th * gh, tw * gw
    hy = unit * draw(st.integers(0, (h - th) // (2 * unit)))
    hx = unit * draw(st.integers(0, (w - tw) // (2 * unit)))
    halo = hy if draw(st.booleans()) and hy * 2 + tw <= w else (hy, hx)
    return (h, w), (th, tw), halo


@settings(max_examples=40, deadline=None)
@given(geometries())
def test_tile_grid_and_build_match_jax(geo):
    (h, w), (th, tw), halo = geo
    assert col.tile_grid(h, w, th, tw, halo) == jcol.tile_grid(h, w, th, tw,
                                                               halo)
    assert _info(col.TileInfo.build((h, w), (th, tw), halo)) == \
        _info(jcol.TileInfo.build((h, w), (th, tw), halo))


@settings(max_examples=40, deadline=None)
@given(geometries(unit=2), st.sampled_from([1, 2, 4, 8, 16, 32]))
def test_tile_info_scaled_matches_jax(geo, k):
    info = col.TileInfo.build(*geo)
    jinfo = jcol.TileInfo.build(*geo)
    try:
        want = _info(jinfo.scaled(k))
    except ValueError:
        with pytest.raises(ValueError, match='divisible'):
            info.scaled(k)
        return
    assert _info(info.scaled(k)) == want


@pytest.mark.parametrize('shape', [(48, 48), (24, 24), (12, 12), (6, 6),
                                   (48, 24), (7, 7)])
def test_scale_for_matches_jax(shape):
    info = col.TileInfo.build((64, 64), (32, 32), 8)
    jinfo = jcol.TileInfo.build((64, 64), (32, 32), 8)
    try:
        want = jinfo.scale_for(shape)
    except ValueError:
        with pytest.raises(ValueError, match='evenly divide'):
            info.scale_for(shape)
        return
    assert info.scale_for(shape) == want


@pytest.mark.parametrize('h,w,n', [
    (2048, 1024, 8), (64, 128, 8), (1024, 2048, 2), (1024, 2048, 4),
    (512, 1024, 1), (384, 384, 4), (96, 60, 6), (63, 127, 8)])
def test_choose_tile_grid_matches_jax(h, w, n):
    try:
        want = jcol.choose_tile_grid(h, w, n)
    except ValueError:
        with pytest.raises(ValueError, match='cannot split'):
            col.choose_tile_grid(h, w, n)
        return
    assert col.choose_tile_grid(h, w, n) == want


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 9), st.integers(1, 4))
def test_pad_batch_to_multiple_matches_jax(n, multiple):
    rng = np.random.default_rng(n * 10 + multiple)
    batch = {'x': rng.standard_normal((n, 3)).astype(np.float32),
             'y': {'z': np.arange(n, dtype=np.int32)}}
    got, n_got = mesh.pad_batch_to_multiple(batch, multiple)
    want, n_want = jmesh.pad_batch_to_multiple(batch, multiple)
    assert n_got == n_want == n
    np.testing.assert_array_equal(got['x'], np.asarray(want['x']))
    np.testing.assert_array_equal(got['y']['z'], np.asarray(want['y']['z']))
    assert len(got['x']) % multiple == 0


TILINGS = [((64, 64), (32, 32), 8), ((64, 128), (32, 32), (8, 0)),
           ((96, 64), (32, 32), 4), ((64, 96), (32, 48), (16, 8))]


@pytest.mark.parametrize('geo', TILINGS, ids=str)
def test_spatial_tiles_and_stitch_match_jax(geo):
    (h, w), (th, tw), halo = geo
    img = np.random.default_rng(1).standard_normal((h, w, 3)).astype(
        np.float32)
    tiles = col.spatial_tiles(torch.from_numpy(img), th, tw, halo)
    jtiles = jcol.spatial_tiles(jnp.asarray(img), th, tw, halo)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jtiles))
    out = col.stitch_tiles(tiles * 2, h, w, th, tw, halo)
    jout = jcol.stitch_tiles(jtiles * 2, h, w, th, tw, halo)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out.numpy(), img * 2)


@pytest.mark.parametrize('k', [1, 2, 4])
def test_assemble_and_extract_match_jax(k):
    """At feature stride k: ``assemble_full`` places the cores,
    ``extract_tiles`` cuts the halo'd windows back out, as JAX's."""
    info = col.TileInfo.build((64, 64), (32, 32), 8)
    jinfo = jcol.TileInfo.build((64, 64), (32, 32), 8)
    feats = np.random.default_rng(k).standard_normal(
        (4, 48 // k, 48 // k, 5)).astype(np.float32)
    full = info.assemble_full(torch.from_numpy(feats))
    jfull = jinfo.assemble_full(jnp.asarray(feats))
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))
    np.testing.assert_array_equal(info.extract_tiles(full).numpy(),
                                  np.asarray(jinfo.extract_tiles(jfull)))


def test_resync_refills_halo_as_jax():
    """JAX's halo-corruption test (tests/test_parallel.py): a resync
    replaces every halo value with the other tiles' cores."""
    img = np.random.default_rng(5).standard_normal((64, 64, 4)).astype(
        np.float32)
    info = col.TileInfo.build((64, 64), (32, 32), 8)
    tiles = col.spatial_tiles(torch.from_numpy(img), 32, 32, 8)
    core = torch.zeros(tiles.shape, dtype=torch.bool)
    for i, (y, x, sy, sx) in enumerate(info.origins):
        core[i, y - sy:y - sy + 32, x - sx:x - sx + 32] = True
    corrupted = torch.where(core, tiles, 999.0)
    restored = info.resync(corrupted)
    torch.testing.assert_close(restored, tiles, rtol=0, atol=0)
    jinfo = jcol.TileInfo.build((64, 64), (32, 32), 8)
    np.testing.assert_array_equal(
        restored.numpy(), np.asarray(jinfo.resync(jnp.asarray(
            corrupted.numpy()))))


def test_tiled_forward_of_a_local_op_matches_jax():
    """A 3×3 conv over 8 tiles with a 4-pixel halo (JAX's test at one
    device): the stitched result equals JAX's, and the monolithic conv
    in the interior."""
    rng = np.random.default_rng(2)
    img = rng.standard_normal((64, 256, 3)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, 3, 2)).astype(np.float32)
    weight = torch.from_numpy(kernel).permute(3, 2, 0, 1)

    def conv(x):                                       # NHWC
        return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), weight,
                                          padding=1).permute(0, 2, 3, 1)

    def jconv(x):
        return jax.lax.conv_general_dilated(
            x, jnp.asarray(kernel), (1, 1), 'SAME',
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'))

    out = col.tiled_forward(lambda _, t: conv(t), None, torch.from_numpy(img),
                            32, 32, 4)
    jout = jcol.tiled_forward(lambda _, t: jconv(t), None, jnp.asarray(img),
                              32, 32, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    mono = conv(torch.from_numpy(img)[None])[0]
    torch.testing.assert_close(out[4:-4, 4:-4], mono[4:-4, 4:-4],
                               rtol=1e-5, atol=1e-5)


def test_tiles_must_divide_and_fit():
    img = torch.zeros(64, 64, 3)
    with pytest.raises(ValueError, match='does not divide'):
        col.spatial_tiles(img, 48, 32, 0)
    with pytest.raises(ValueError, match='too large'):
        col.spatial_tiles(img, 32, 32, 24)
    three = col.TileInfo.build((96, 32), (32, 32), 0, mesh.DataMesh(0, 2))
    with pytest.raises(ValueError, match='do not divide over 2 ranks'):
        three.local


# ---------------------------------------------------------------------------
# the exact tiled ensemble
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tiled_pair():
    """JAX's and the port's tiled and monolithic forwards of the narrow
    ensemble (with depth heads) at 384×384: a 2×2 grid of 192-pixel tiles
    with a 64-pixel halo (every coordinate divides by 32)."""
    h = w = 384
    jmodel = _TinyEnsemble(num_classes=NC, include_depth=True)
    variables = random_variables(jmodel, np.zeros((1, h, w, 3), np.float32),
                                 seed=6, train=False)
    img = np.random.default_rng(4).standard_normal((h, w, 3)).astype(
        np.float32)
    with jax.default_matmul_precision('float32'):
        jtiled = jax.jit(lambda v, x: jcol.tiled_forward(
            lambda vv, t, ti: jmodel.apply(vv, t, train=False, tile_info=ti),
            v, x, 192, 192, 64, with_tile_info=True))(variables,
                                                      jnp.asarray(img))
    model = narrow_ensemble(NC, include_depth=True)
    model.load_state_dict(flax_to_torch(variables))
    model.eval()
    x = torch.from_numpy(img)
    with torch.no_grad():
        tiled = col.tiled_forward(
            lambda _, t, info: model(t, tile_info=info), None, x, 192, 192,
            64, with_tile_info=True)
        mono = {k: v[0] for k, v in model(x[None]).items()}
    return jax.device_get(jtiled), tiled, mono


KEYS = ('segmentation', 'segformer_seg', 'deeplabv3plus_seg', 'depth')


@pytest.mark.parametrize('key', KEYS)
def test_tiled_ensemble_matches_jax_tiled(tiled_pair, key):
    jtiled, tiled, _ = tiled_pair
    np.testing.assert_allclose(tiled[key].numpy(), np.asarray(jtiled[key]),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize('key', KEYS)
def test_tiled_ensemble_matches_monolithic(tiled_pair, key):
    """Exact to f32 rounding: the halo resyncs, SR attention's K/V and
    ASPP on the assembled full map."""
    _, tiled, mono = tiled_pair
    torch.testing.assert_close(tiled[key], mono[key], rtol=2e-4, atol=2e-5)
    if key != 'depth':
        assert torch.equal(tiled[key].argmax(-1), mono[key].argmax(-1))


# ---------------------------------------------------------------------------
# the evaluator's tiling
# ---------------------------------------------------------------------------

class _ConvNet(torch.nn.Module):
    """Two 3×3 convs (receptive radius 2), NHWC in and out."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.a = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.b = torch.nn.Conv2d(8, NC, 3, padding=1)

    def forward(self, x):
        y = self.b(torch.relu(self.a(x.permute(0, 3, 1, 2))))
        return {'segmentation': y.permute(0, 2, 3, 1)}


def _loader(h, w, n=2, b=2):
    rng = np.random.default_rng(7)
    return [{'image': rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
             'label': rng.integers(0, NC, (b, h, w)).astype(np.int32),
             'weather_id': np.arange(i, i + b, dtype=np.int32) % 5,
             'sample_id': np.arange(b, dtype=np.int32)} for i in range(n)]


def test_evaluator_tiling_on_equals_off_for_a_conv_model():
    """JAX's tests/test_parallel.py case: with a halo over the receptive
    radius the tiled sweep's metrics equal the monolithic sweep's."""
    res = {}
    for tiling in ('off', 'on'):
        cfg = {'model': {'num_classes': NC}, 'tpu': {'precision': 'fp32'},
               'evaluation': {'spatial_tiling': tiling, 'tile_size': [32, 32],
                              'tile_halo': 8}}
        ev = Evaluator(_ConvNet(), cfg, device='cpu')
        res[tiling] = (ev.run(_loader(64, 128), seed=3), ev.last_acc)
    (off, acc_off), (on, acc_on) = res['off'], res['on']
    assert torch.equal(acc_on['cm'], acc_off['cm'])
    assert abs(on['overall_miou'] - off['overall_miou']) < 1e-6
    assert abs(on['expected_calibration_error']
               - off['expected_calibration_error']) < 1e-6


def test_evaluator_tiled_ensemble_counts_equal_monolithic():
    """The narrow ensemble through the sweep at 384×384 with exact tiling
    (192-pixel tiles, 64-pixel halo): the same confusion matrices as
    without tiling, ECE within 1e-6 and the disagreement AUROC within 1e-6
    (the tiled logits differ from the monolithic ones by f32 rounding,
    which moves a pixel's score between the 2^20 histogram bins)."""
    state = narrow_ensemble(NC, include_depth=False).state_dict()
    res, acc = {}, {}
    for tiling in ('off', 'on'):
        model = narrow_ensemble(NC, include_depth=False)
        model.load_state_dict(state)
        cfg = {'model': {'num_classes': NC}, 'tpu': {'precision': 'fp32'},
               'evaluation': {'spatial_tiling': tiling,
                              'tile_size': [192, 192], 'tile_halo': 64}}
        ev = Evaluator(model, cfg, device='cpu')
        res[tiling] = ev.run(_loader(384, 384, n=1, b=1), seed=1)
        acc[tiling] = ev.last_acc
    assert torch.equal(acc['on']['cm'], acc['off']['cm'])
    for key in ('expected_calibration_error', 'ensemble_disagreement_auroc'):
        assert abs(res['on'][key] - res['off'][key]) <= 1e-6, key


@pytest.mark.parametrize('size,hw,want', [
    (1, (1024, 2048), False), (2, (1024, 2048), True),
    (2, (512, 1024), False), (4, (2048, 1024), True)])
def test_evaluator_auto_tiling(size, hw, want):
    """'auto' tiles at 2048×1024 pixels and up when the mesh has more than
    one rank; tile_size 'auto' is choose_tile_grid over its size."""
    ev = Evaluator(_ConvNet(), {'model': {'num_classes': NC}}, device='cpu',
                   mesh=mesh.DataMesh(0, size))
    assert ev.use_tiling(*hw) is want
    assert ev.tiles(*hw) == jcol.choose_tile_grid(*hw, size)


# ---------------------------------------------------------------------------
# the sharded AUROC, the loader, the config, the mesh on one process
# ---------------------------------------------------------------------------

def test_auroc_exact_sharded_one_rank_matches_jax():
    g = torch.Generator().manual_seed(3)
    s = torch.rand(200, generator=g).round(decimals=2)      # ties
    lab = (torch.rand(200, generator=g) < 0.3).float()
    w = (torch.rand(200, generator=g) < 0.8).float()
    want = float(jauroc_sharded(jnp.asarray(s.numpy()),
                                jnp.asarray(lab.numpy()),
                                jnp.asarray(w.numpy()),
                                jmesh.create_mesh(jax.devices()[:2])))
    for m in (None, mesh.DataMesh()):
        got = auroc_exact_sharded(s, lab, w, m).item()
        assert abs(got - want) <= 1e-6
        assert got == auroc_exact(s, lab, w).item()


@pytest.mark.parametrize('index', [0, 1])
@pytest.mark.parametrize('shuffle,drop_last', [(True, None), (False, True)])
def test_batch_iterator_process_slices_match_jax(index, shuffle, drop_last):
    ds = ToyDataset(18)
    kw = dict(batch_size=6, shuffle=shuffle, seed=4, drop_last=drop_last,
              num_threads=1, process_index=index, process_count=2)
    got = [b['sample_id'].tolist() for b in BatchIterator(ds, **kw)]
    want = [b['sample_id'].tolist() for b in JBatchIterator(ds, **kw)]
    assert got == want and all(len(b) == 3 for b in got)


def test_create_dataloader_without_a_group_loads_whole_batches():
    loader = create_dataloader(ToyDataset(8), batch_size=4, shuffle=False,
                               num_workers=1)
    assert (loader.process_index, loader.process_count) == (0, 1)
    assert [len(b['sample_id']) for b in loader] == [4, 4]


@pytest.mark.parametrize('shape,exc', [
    ('auto', None), ({'data': 1}, None), ({'data': 8}, None),
    ({'data': 2, 'model': 1}, None), ({'data': 2, 'model': 2}, None),
    ({'model': 4}, None), ({'seq': 2}, ValueError),
    ([2], ValueError)], ids=str)
def test_check_tpu_section(shape, exc):
    cfg = {'tpu': {'mesh_shape': shape}}
    if exc is None:
        check_tpu_section(cfg)
    else:
        with pytest.raises(exc):
            check_tpu_section(cfg)


@pytest.mark.parametrize('shape,exc', [
    ('auto', None), (None, None), ({'data': 1}, None),
    ({'data': 1, 'model': 1}, None), ({'data': 2}, ValueError),
    ({'model': 2}, ValueError), ([1], ValueError)], ids=str)
def test_create_mesh_on_one_process(shape, exc):
    """One process is a world of 1: a mesh of more ranks (a data axis of 2,
    a model axis of 2) is refused for its size, as JAX refuses a mesh
    larger than its devices."""
    if exc is None:
        m = mesh.create_mesh(mesh_shape=shape)
        assert (m.rank, m.size, m.shape, m.axis_names) == (
            0, 1, {'data': 1}, ('data',))
        assert m.data is m and not mesh.has_model_axis(m)
    else:
        with pytest.raises(exc, match='needs 2 devices, have 1' if
                           isinstance(shape, dict) else None):
            mesh.create_mesh(mesh_shape=shape)
    with pytest.raises(ValueError, match='one process per device'):
        mesh.create_mesh(devices=['a', 'b'])


def test_single_process_helpers():
    assert mesh.init_distributed() is False
    one = mesh.DataMesh()
    batch = {'a': np.arange(6)}
    np.testing.assert_array_equal(mesh.shard_batch(batch, one)['a'],
                                  batch['a'])
    two = mesh.DataMesh(1, 2)
    np.testing.assert_array_equal(mesh.shard_batch(batch, two)['a'],
                                  [3, 4, 5])
    with pytest.raises(ValueError, match='pad it first'):
        mesh.shard_batch({'a': np.arange(5)}, two)
    t = {'w': torch.ones(2)}
    assert mesh.replicate(t, one) is t
    tree = {'x': torch.arange(3.0)}
    assert col.psum_tree(tree) is tree and col.pmean_tree(tree) is tree
    assert col.all_gather_batch(tree['x']) is tree['x']
    assert col.sync_sum(tree['x']) is tree['x']
    assert (col.global_rows(3), col.first_row(3)) == (3, 0)


def test_parallel_facade_exports_the_jax_names():
    assert sorted(parallel.__all__) == sorted(jparallel.__all__)
    assert all(callable(getattr(parallel, n)) for n in parallel.__all__)
    assert (mesh.DATA_AXIS, mesh.MODEL_AXIS) == (jmesh.DATA_AXIS,
                                                 jmesh.MODEL_AXIS)


# ---------------------------------------------------------------------------
# a rank's rows: the dropout hash and the batch split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('first', [0, 2, 5])
def test_dropout_hash_rows_take_the_global_index(first):
    """A seed (seed, b0) hashes row b as the global batch's row b0 + b,
    as JAX's mask over the global batch does."""
    seed = torch.tensor(-987654321, dtype=torch.int32)
    shape = (2, 6, 8, 16)
    got = dropout_keep_mask(shape, torch.stack(
        [seed, torch.tensor(first, dtype=torch.int32)]), 0.1)
    want = np.asarray(jht.dropout_keep_mask((first + 2,) + shape[1:],
                                            jnp.int32(seed.item()), 0.1))
    np.testing.assert_array_equal(got.numpy(), want[first:])


def test_rank_seed_under_a_mesh():
    seed = torch.tensor(5, dtype=torch.int32)
    assert rank_seed(seed, 3) is seed
    with col.data_parallel(mesh.DataMesh(1, 2)):
        got = rank_seed(seed, 3)
        assert (col.global_rows(3), col.first_row(3)) == (6, 3)
    assert got.tolist() == [5, 3] and got.dtype == torch.int32
    assert col.active_mesh() is None


def test_trainer_rows_pad_and_split_the_global_batch():
    """A loader's batch of 3 on rank 1 of 2: padded by repeating the last
    row, rows 2 and 3 kept, the padded one masked (JAX's ``_pad_batch``)."""
    batch = {'image': np.arange(3)[:, None] * np.ones((3, 2)),
             'label': np.arange(3), 'weather_id': np.arange(3),
             'sample_id': np.arange(3)}
    stub = SimpleNamespace(mesh=mesh.DataMesh(1, 2))
    (out,) = AdverseWeatherTrainer._rows(stub, [batch])
    np.testing.assert_array_equal(out['label'], [2, 2])
    np.testing.assert_array_equal(out['sample_mask'], [1.0, 0.0])
    # a process-sharded loader's batch is this rank's rows already
    loader = type('Sharded', (), {'process_count': 2,
                                  '__iter__': lambda self: iter([batch])})()
    (out,) = AdverseWeatherTrainer._rows(stub, loader)
    assert out['label'] is batch['label']
    np.testing.assert_array_equal(out['sample_mask'], [1.0, 1.0, 1.0])


def test_train_step_local_rows():
    """``TrainStep._local``: the global batch padded to the mesh, this
    rank's rows, their mask and the padded size."""
    stub = SimpleNamespace(mesh=mesh.DataMesh(1, 2),
                           device=torch.device('cpu'))
    imgs = torch.arange(3).reshape(3, 1, 1, 1).expand(3, 2, 2, 3)
    out = TrainStep._local(stub, imgs, torch.arange(3), torch.arange(3),
                           None)
    assert out[0][:, 0, 0, 0].tolist() == [2, 2]
    assert out[1].tolist() == [2, 2] and out[3].tolist() == [1.0, 0.0]
    assert out[4] == 4
