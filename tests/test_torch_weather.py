"""The port's corruption, depth estimate and batch preparation against the
JAX package on the CPU.

``apply_corruption`` is fed the JAX path's own draws (made from its per-sample
keys exactly as ``_corrupt_batch_fused`` makes them) and must give JAX's
uint8 output up to the rounding of the truncating quantisation: |Δ| ≤ 1 and
at least 99.9% of values exact. The reference for that count runs
``_corrupt_batch_fused`` op by op: under ``jit`` XLA's CPU backend contracts
the blur's multiply-adds into FMAs, which moves the last bit of about a
third of the blurred values and a few percent of the rain image's uint8
values by one; against the jitted ``corrupt_batch`` only |Δ| ≤ 1 is held.
The torch draws are checked at the level of their distributions, since the
two frameworks' random streams differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.data import pipeline as jpipe
from awsegbench.weather import corruption as jcorr
from awsegbench.weather import depth as jdepth
from awsegbench_torch.data import pipeline
from awsegbench_torch.weather import corruption, depth

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, W = 5, 64, 256


def _jax_draws(keys, h, w):
    """Every draw of ``_corrupt_batch_fused``, from the same keys."""
    def fog(key):
        k_int, k_depth = jax.random.split(key)
        i = jcorr._resolve_intensity(k_int, 'fog', None)
        return i, jax.random.normal(k_depth, (h, w), jnp.float32) * 10.0

    def night(key):
        k_int, k_bf, k_noise = jax.random.split(key, 3)
        i = jcorr._resolve_intensity(k_int, 'night', None)
        lo, hi = jcorr.NIGHT_PARAMS['brightness_reduction']
        bf = 1.0 - i * jax.random.uniform(k_bf, (), minval=lo, maxval=hi)
        noise = jax.random.normal(k_noise, (h, w, 3), jnp.float32) * (
            jcorr.NIGHT_PARAMS['noise_std'] / 255.0)
        return i, bf, noise

    @jax.jit
    def draws(keys):
        i_fog, fog_noise = jax.vmap(fog)(keys)
        i_rain, rx, ry, rex, rey, rrad, rvalid = jax.vmap(
            lambda k: jcorr._rain_splat_params(k, h, w))(keys)
        i_snow, sx, sy, srad, svalid, use7 = jax.vmap(
            lambda k: jcorr._snow_splat_params(k, h, w))(keys)
        i_night, bf, night_noise = jax.vmap(night)(keys)
        return dict(fog_intensity=i_fog, fog_noise=fog_noise,
                    rain_intensity=i_rain, rain_ax=rx, rain_ay=ry,
                    rain_bx=rex, rain_by=rey, rain_radius=rrad,
                    rain_valid=rvalid, snow_intensity=i_snow, snow_x=sx,
                    snow_y=sy, snow_radius=srad, snow_valid=svalid,
                    snow_use7=use7, night_intensity=i_night,
                    night_brightness=bf, night_noise=night_noise)

    return {k: torch.from_numpy(np.array(v)) for k, v in draws(keys).items()}


@pytest.fixture(scope='module')
def batch():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    wids = np.arange(B, dtype=np.int32)          # clean, fog, rain, snow, night
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    eager = np.asarray(jcorr._corrupt_batch_fused(jnp.asarray(images),
                                                  jnp.asarray(wids), keys))
    jitted = np.asarray(jcorr.corrupt_batch(jnp.asarray(images),
                                            jnp.asarray(wids), keys))
    return images, wids, keys, eager, jitted


def _assert_u8_close(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


def test_apply_corruption_matches_jax(batch):
    images, wids, keys, eager, jitted = batch
    got = corruption.apply_corruption(torch.from_numpy(images),
                                      torch.from_numpy(wids),
                                      _jax_draws(keys, H, W)).numpy()
    assert got.dtype == np.uint8 and got.shape == eager.shape
    np.testing.assert_array_equal(got[0], images[0])     # clean untouched
    for i in range(B):                                   # each weather
        _assert_u8_close(got[i], eager[i])
    assert np.abs(got.astype(np.int16) - jitted).max() <= 1
    assert (got[2] != images[2]).mean() > 0.5            # rain did change it


def test_prepare_batch_matches_jax(batch):
    """prepare_batch = corrupt → depth → normalize, as the JAX one composes
    it (here over the op-by-op corruption, see the module docstring)."""
    images, wids, keys, eager, _ = batch
    labels = np.zeros((B, H, W), np.int32)
    got = pipeline.prepare_batch(torch.from_numpy(images),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(wids),
                                 draws=_jax_draws(keys, H, W),
                                 include_depth=True)
    want_image = np.asarray(jpipe.normalize_imagenet(jnp.asarray(eager)))
    want_depth = np.asarray(jdepth.estimate_depth_batch(jnp.asarray(eager)))
    # one uint8 step of a pixel is 1/(255·std) ≤ 0.0175 after normalising
    diff = np.abs(got['image'].numpy() - want_image)
    assert diff.max() <= 1 / (255 * 0.224) + 1e-5
    assert (diff <= 1e-5).mean() >= 0.999
    np.testing.assert_allclose(got['depth'].numpy(), want_depth, rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got['label'], torch.from_numpy(labels))


def test_normalize_imagenet():
    u8 = np.random.default_rng(1).integers(0, 256, (2, 8, 9, 3),
                                           dtype=np.uint8)
    np.testing.assert_allclose(
        pipeline.normalize_imagenet(torch.from_numpy(u8)).numpy(),
        np.asarray(jpipe.normalize_imagenet(jnp.asarray(u8))),
        rtol=1e-6, atol=1e-6)


def test_estimate_depth_batch():
    u8 = np.random.default_rng(2).integers(0, 256, (3, 40, 56, 3),
                                           dtype=np.uint8)
    got = depth.estimate_depth_batch(torch.from_numpy(u8)).numpy()
    want = np.asarray(jdepth.estimate_depth_batch(jnp.asarray(u8)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_torch_draw_distributions():
    b, h, w = 256, 48, 96
    g = torch.Generator().manual_seed(0)
    d = corruption.draw_corruption(torch.zeros(b, dtype=torch.long), h, w, g)
    for name, (lo, hi) in corruption.DEFAULT_INTENSITY.items():
        i = d[f'{name}_intensity']
        assert i.shape == (b,) and lo <= i.min() and i.max() < hi
        assert abs(i.mean().item() - (lo + hi) / 2) < 0.05
    # drop counts: int(100 + i·400) rain streaks, int(50 + i·150) flakes
    n_rain = d['rain_valid'].sum(1)
    assert torch.equal(n_rain, (100 + d['rain_intensity'] * 400).int().long())
    assert 180 <= n_rain.min() and n_rain.max() <= 420
    n_snow = d['snow_valid'].sum(1)
    assert torch.equal(n_snow, (50 + d['snow_intensity'] * 150).int().long())
    assert 80 <= n_snow.min() and n_snow.max() <= 155
    assert d['rain_valid'].shape == d['snow_valid'].shape == (b, 500)
    # valid slots form a prefix
    assert torch.equal(d['rain_valid'].cumprod(1).bool(), d['rain_valid'])
    # geometry
    for k in ('rain_ax', 'snow_x'):
        assert d[k].min() >= 0 and d[k].max() <= w - 1
        assert torch.equal(d[k], d[k].round())
    for k in ('rain_ay', 'snow_y'):
        assert d[k].min() >= 0 and d[k].max() <= h - 1
    assert d['rain_bx'].min() >= 0 and d['rain_bx'].max() <= w - 1
    assert d['rain_by'].min() >= 0 and d['rain_by'].max() <= h - 1
    length = torch.hypot(d['rain_bx'] - d['rain_ax'],
                         d['rain_by'] - d['rain_ay'])
    assert length.max() <= 20
    assert set(d['rain_radius'].unique().tolist()) == {0.5, 1.5}
    assert set(d['snow_radius'][:, :200].unique().tolist()) == {2.0, 8.0}
    assert not d['snow_valid'][:, 200:].any()
    assert 0.35 < d['snow_use7'].float().mean() < 0.65
    # noise and night factor
    assert abs(d['fog_noise'].std().item() - 10.0) < 0.2
    assert abs(d['night_noise'].std().item() * 255 / 5.0 - 1.0) < 0.02
    bf = d['night_brightness']
    assert 1 - 0.8 * 0.6 <= bf.min() and bf.max() <= 1 - 0.4 * 0.2


def test_corrupt_batch_cpu_and_card_rule():
    g = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (B, 48, 64, 3), dtype=torch.uint8,
                           generator=g)
    out = corruption.corrupt_batch(images, torch.arange(B), g, device='cpu')
    assert out.dtype == torch.uint8 and out.shape == images.shape
    assert torch.equal(out[0], images[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            corruption.corrupt_batch(images, torch.arange(B), g)


def test_prepare_batch_needs_a_generator_or_draws():
    with pytest.raises(ValueError, match='generator or draws'):
        pipeline.prepare_batch(torch.zeros(1, 8, 8, 3, dtype=torch.uint8),
                               torch.zeros(1, 8, 8), torch.zeros(1))
