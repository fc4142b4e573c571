"""K3/K4's tile walk against the plain splat mask and JAX's batched kernel,
on the CPU.

The CUDA kernel behind ``splat_coverage_batched`` (K3) and
``splat_coverage_windowed`` (K4), ``splat_tiles_kernel`` in
``csrc/splat.cu``, keeps for each tile the valid drops whose box, inflated
by r plus one pixel, meets the tile, and tests the tile's pixels against
those only. ``ops/splat.py::splat_coverage_tiles_plain`` is that walk in
plain torch. It must equal ``splat_coverage_plain`` bit for bit, which
holds when the cull never drops a drop that covers a pixel of the tile:
both are tested here, over random capsules, over drawn edge cases (ragged
images, 1×W and H×1, no slots or no valid slot, boxes across tile and
image borders, zero-length segments, the four production radii) and
against JAX's ``splat_coverage_batched`` (interpret mode) on production
rain and snow draws. The kernel itself is held bit-equal to the plain
version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from awsegbench.ops import splat as jsplat
from awsegbench.weather import corruption as jcorr
from awsegbench_torch.ops import splat
from test_splat import _random_capsules

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RADII = (0.5, 1.5, 1.0, 4.0)        # rain streaks' and snow flakes' radii
TILES = (splat.BATCH_TILE, splat.IMAGE_TILE, (8, 16), (4, 4), (3, 5))


def _params(caps) -> torch.Tensor:
    """Six [B, N] arrays (ax, ay, bx, by, r, valid) → [B, N, 8]."""
    return splat.pack_params(*(torch.from_numpy(np.asarray(c))
                               for c in caps))


def _batch(b, n, h, w, n_valid, seed=0) -> torch.Tensor:
    caps = [_random_capsules(n, h, w, seed=seed + i, n_valid=n_valid)
            for i in range(b)]
    return _params([np.stack([c[j] for c in caps]).reshape(b, n)
                    for j in range(6)])


@pytest.mark.parametrize('b,h,w,n,n_valid,tile', [
    (2, 64, 256, 64, 50, splat.BATCH_TILE),   # several of the batch's tiles
    (1, 64, 256, 64, 50, splat.IMAGE_TILE),   # one image's tiles
    (3, 37, 101, 40, 30, splat.BATCH_TILE),   # ragged: partial tiles, W % 4
    (1, 37, 101, 40, 30, splat.IMAGE_TILE),   # != 0
    (3, 37, 101, 40, 30, (8, 16)),            # many small tiles
    (1, 1, 300, 20, 20, splat.IMAGE_TILE),    # 1×W
    (3, 300, 1, 20, 20, splat.BATCH_TILE),    # H×1
    (2, 40, 130, 0, 0, splat.BATCH_TILE),     # no drop slots
    (2, 40, 130, 16, 0, splat.BATCH_TILE),    # no valid slot
])
def test_tile_walk_equals_plain(b, h, w, n, n_valid, tile):
    params = _batch(b, n, h, w, n_valid, seed=h + w)
    want = splat.splat_coverage_plain(params, h, w)
    got = splat.splat_coverage_tiles_plain(params, h, w, tile)
    assert got.dtype == torch.float32 and got.shape == (b, h, w)
    assert torch.equal(got, want)
    assert bool(want.any()) == (n_valid > 0)


def _coord(size):
    """A drop coordinate on an axis of ``size`` pixels: anywhere a little
    beyond the image, on whole and half pixels, or near a tile border."""
    near_border = st.tuples(st.sampled_from([0, 3, 4, 5, 8, 16, 32, size]),
                            st.floats(-1.5, 1.5, width=32))
    return st.one_of(
        st.floats(-5.0, size + 5.0, width=32),
        st.integers(-3, size + 3).map(float),
        st.integers(-6, 2 * size + 6).map(lambda k: k / 2.0),
        near_border.map(lambda t: float(np.float32(t[0] + t[1]))))


@st.composite
def _drops(draw, h, w, max_n):
    """[N, 6] rows (ax, ay, bx, by, r, valid), zero-length ones included."""
    rows = []
    for _ in range(draw(st.integers(0, max_n))):
        ax, ay = draw(_coord(w)), draw(_coord(h))
        if draw(st.booleans()):                  # a snow flake: a circle
            bx, by = ax, ay
        else:
            bx, by = draw(_coord(w)), draw(_coord(h))
        rows.append((ax, ay, bx, by, draw(st.sampled_from(RADII)),
                     draw(st.booleans())))
    return np.array(rows, np.float32).reshape(-1, 6)


@st.composite
def _scenes(draw):
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 70))
    b = draw(st.integers(1, 3))
    drops = [draw(_drops(h, w, 10)) for _ in range(b)]
    n = max(len(d) for d in drops)
    rows = np.zeros((b, n, 6), np.float32)
    for i, d in enumerate(drops):
        rows[i, :len(d)] = d                     # padding slots are invalid
    return h, w, rows, draw(st.sampled_from(TILES))


@settings(max_examples=60, deadline=None)
@given(_scenes())
def test_tile_walk_equals_plain_on_edge_cases(scene):
    h, w, rows, tile = scene
    params = _params([rows[..., j] for j in range(5)]
                     + [rows[..., 5] > 0])
    want = splat.splat_coverage_plain(params, h, w)
    assert torch.equal(splat.splat_coverage_tiles_plain(params, h, w, tile),
                       want)


def _assert_cull_keeps_covering_drops(params, h, w, tile):
    """Every pixel a drop covers lies in its inflated box, so every tile
    (clipped to the image, as the kernel culls) holding such a pixel keeps
    the drop."""
    th, tw = tile
    x0, x1, y0, y1 = splat.drop_boxes(params).tolist()
    cov = splat.splat_coverage_plain(params[None, None], h, w)[0].bool()
    ys, xs = torch.nonzero(cov, as_tuple=True)
    assert ((xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)).all()
    for ty, tx in {(int(y) // th * th, int(x) // tw * tw)
                   for y, x in zip(ys, xs)}:
        assert x1 >= tx and x0 < min(tx + tw, w)
        assert y1 >= ty and y0 < min(ty + th, h)


@settings(max_examples=150, deadline=None)
@given(st.data())
def test_cull_never_drops_a_covering_drop(data):
    h, w = data.draw(st.integers(1, 48)), data.draw(st.integers(1, 80))
    rows = data.draw(_drops(h, w, 1).filter(len))
    rows[0, 5] = 1.0
    params = _params([rows[:, j] for j in range(5)] + [rows[:, 5] > 0])[0]
    _assert_cull_keeps_covering_drops(params, h, w,
                                      data.draw(st.sampled_from(TILES)))


def test_cull_never_drops_a_covering_drop_random_capsules():
    h, w = 64, 256
    params = _batch(1, 120, h, w, 120, seed=5)[0]
    for d in range(params.shape[0]):
        for tile in (splat.BATCH_TILE, splat.IMAGE_TILE):
            _assert_cull_keeps_covering_drops(params[d], h, w, tile)


@pytest.mark.parametrize('seed', [0, 1])
def test_tile_walk_equals_jax_batched_kernel(seed):
    """Production draws as JAX's ``_corrupt_batch_fused`` assembles them
    (rain, snow, fog, rain: the fog image's slots are all invalid), through
    ``prepare_splat_batch`` and the interpret-mode batched kernel."""
    h, w = 64, 256
    wid = jnp.asarray([jcorr.WEATHER_IDS[k]
                       for k in ('rain', 'snow', 'fog', 'rain')])
    keys = jax.random.split(jax.random.PRNGKey(seed), wid.shape[0])
    _, rx, ry, rex, rey, rrad, rvalid = jax.vmap(
        lambda k: jcorr._rain_splat_params(k, h, w))(keys)
    _, sx, sy, srad, svalid, _ = jax.vmap(
        lambda k: jcorr._snow_splat_params(k, h, w))(keys)
    rain = (wid == jcorr.WEATHER_IDS['rain'])[:, None]
    snow = (wid == jcorr.WEATHER_IDS['snow'])[:, None]
    caps = (jnp.where(rain, rx, sx), jnp.where(rain, ry, sy),
            jnp.where(rain, rex, sx), jnp.where(rain, rey, sy),
            jnp.where(rain, rrad, srad), jnp.where(rain, rvalid, svalid & snow))
    nv, prm, winpos = jax.vmap(lambda *a: jsplat.prepare_splat_batch(
        *a, h, w))(*caps)
    want = np.asarray(jsplat.splat_coverage_batched(nv, prm, winpos, h, w,
                                                    interpret=True))
    params = _params([np.array(c) for c in caps])
    for tile in (splat.BATCH_TILE, splat.IMAGE_TILE):
        got = splat.splat_coverage_tiles_plain(params, h, w, tile)
        np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, splat.splat_coverage_plain(params, h, w))
    assert want[[0, 1, 3]].any(axis=(1, 2)).all() and not want[2].any()
