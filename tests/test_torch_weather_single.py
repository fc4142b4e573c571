"""The port's single-image corruption API and one-weather batch path against
the JAX package on the CPU.

``apply_weather_effect`` and ``corrupt_batch_static`` are fed the JAX
path's own draws (made from the same keys as ``_corrupt_batch_fused`` makes
them, at B = 1 per image; with a fixed intensity, the draws that intensity
implies) and must give JAX's uint8 output up to the rounding of the
truncating quantisation, as tests/test_torch_weather.py holds the batched
path: |Δ| ≤ 1 and at least 99.9% exact. The one-image splat mask, whose
kernels are K4 and K5 on the card, is held bit for bit against JAX's
``splat_coverage_pallas`` in interpret mode on both sides of its 1 Mpx
dispatch line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.ops import splat as jsplat
from awsegbench.weather import corruption as jcorr
from awsegbench_torch import _build
from awsegbench_torch.ops import splat
from awsegbench_torch.weather import corruption
from test_splat import _random_capsules
from test_torch_weather import _assert_u8_close, _jax_draws

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W = 48, 96


def _jax_draws_at(keys, h, w, intensity=None):
    """``_jax_draws`` with every intensity fixed, as JAX's branches resolve
    a given intensity: the geometry and noise come from the same keys, the
    drop counts and the night factor from the intensity."""
    d = _jax_draws(keys, h, w)
    if intensity is None:
        return d
    b = keys.shape[0]
    i = jnp.full((b,), intensity, jnp.float32)
    n_rain = (100 + i * 400).astype(jnp.int32)
    n_snow = (50 + i * 150).astype(jnp.int32)
    lo, hi = jcorr.NIGHT_PARAMS['brightness_reduction']
    u = jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(k, 3)[1], (), minval=lo, maxval=hi))(keys)
    slots = jnp.arange(jcorr.MAX_RAIN_DROPS)[None]
    new = {**{f'{n}_intensity': i for n in ('fog', 'rain', 'snow', 'night')},
           'rain_valid': slots < n_rain[:, None],
           'snow_valid': slots < n_snow[:, None],
           'night_brightness': 1.0 - i * u}
    return {**d, **{k: torch.from_numpy(np.array(v)) for k, v in new.items()}}


# ---------------------------------------------------------------- the mask

@pytest.mark.parametrize('h,w,windowed', [
    (300, 600, True),       # pads to 320×768: the windowed kernel (K4)
    (1001, 1000, False),    # pads to 1040×1024 > 1 Mpx: the tiled one (K5)
])
def test_splat_coverage_bit_equal_to_pallas(h, w, windowed):
    ax, ay, bx, by, r, valid = _random_capsules(16, h, w, seed=h,
                                                n_valid=12)
    params = jsplat.pack_params(*(jnp.asarray(a) for a in
                                  (ax, ay, bx, by, r, valid)))
    want = np.asarray(jsplat.splat_coverage_pallas(params, h, w,
                                                   interpret=True))
    assert splat.uses_windowed(h, w) == windowed
    got = splat.splat_coverage(torch.from_numpy(np.array(params)), h, w)
    assert got.dtype == torch.float32 and got.shape == (h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize('h,w', [(512, 1024), (1024, 1024), (2048, 1024),
                                 (300, 600), (1001, 1000), (40, 256),
                                 (1000, 1048)])
def test_splat_dispatch_follows_jax(h, w, monkeypatch):
    """K4 where JAX takes its windowed kernel, K5 where its tiled one; the
    stubs stand in for the wrappers (no launch happens on the CPU)."""
    ph, pw = h + (-h) % jsplat.WIN_H, w + (-w) % jsplat.WIN_W
    jax_windowed = ph * pw <= jsplat._V2_MAX_PIXELS
    calls = []
    for name in ('splat_coverage_windowed', 'splat_coverage_tiled'):
        monkeypatch.setattr(splat, name, lambda p, hh, ww, name=name:
                            calls.append(name))
    splat.splat_coverage(torch.zeros(1, 8), h, w)
    assert calls == ['splat_coverage_windowed' if jax_windowed
                     else 'splat_coverage_tiled']


def test_single_image_path_on_cpu_launches_no_kernel():
    g = torch.Generator().manual_seed(0)
    for hw in ((48, 96), (8, 26300)):           # K4's side, K5's side
        img = torch.randint(0, 256, (*hw, 3), dtype=torch.uint8, generator=g)
        out = corruption.apply_weather_effect(img, 'snow', g)
        assert out.shape == img.shape and (out != img).any()
    for fn in (splat.splat_coverage_windowed, splat.splat_coverage_tiled,
               splat.splat_coverage_batched):
        assert _build.launches[fn.__name__] == 0, fn.__name__


# ---------------------------------------------------------------- the API

@pytest.mark.parametrize('weather,intensity', [
    ('clean', None), ('fog', None), ('rain', None), ('snow', None),
    ('night', None), ('fog', 0.45), ('rain', 0.7), ('snow', 0.3),
    ('night', 0.6)])
def test_apply_weather_effect_matches_jax(weather, intensity):
    rng = np.random.default_rng(7)
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jcorr.apply_weather_effect(jnp.asarray(image), weather,
                                                 key, intensity))
    got = corruption.apply_weather_effect(
        torch.from_numpy(image), weather,
        draws=_jax_draws_at(key[None], H, W, intensity)).numpy()
    assert got.dtype == np.uint8 and got.shape == image.shape
    if weather == 'clean':
        np.testing.assert_array_equal(got, image)
        return
    _assert_u8_close(got, want)
    assert (got != image).mean() > 0.5


@pytest.mark.parametrize('weather,intensity', [
    ('fog', None), ('rain', None), ('snow', 0.55), ('night', None)])
def test_corrupt_batch_static_matches_jax(weather, intensity):
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(12), 2)
    want = np.asarray(jcorr.corrupt_batch_static(
        jnp.asarray(images), weather, keys,
        None if intensity is None else jnp.float32(intensity)))
    got = corruption.corrupt_batch_static(
        torch.from_numpy(images), weather,
        draws=_jax_draws_at(keys, H, W, intensity)).numpy()
    for i in range(2):
        _assert_u8_close(got[i], want[i])


def test_float_branches_match_jax():
    """``apply_fog/rain/snow/night`` on a float image, before quantising."""
    rng = np.random.default_rng(9)
    image = rng.random((H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    draws = _jax_draws_at(key[None], H, W, 0.5)
    for name in ('fog', 'rain', 'snow', 'night'):
        want = np.asarray(getattr(jcorr, f'apply_{name}')(
            jnp.asarray(image), key, jnp.float32(0.5)))
        got = getattr(corruption, f'apply_{name}')(torch.from_numpy(image),
                                                   draws=draws).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_draw_corruption_with_intensity():
    """A fixed intensity enters the draws: every weather's intensity, the
    drop counts int(100 + i·400) and int(50 + i·150), the night factor."""
    g = torch.Generator().manual_seed(3)
    d = corruption.draw_corruption(torch.zeros(64, dtype=torch.long), 8, 16,
                                   g, intensity=0.3)
    for name in ('fog', 'rain', 'snow', 'night'):
        assert torch.equal(d[f'{name}_intensity'], torch.full((64,), 0.3))
    i = torch.tensor(0.3)
    assert (d['rain_valid'].sum(1) == int(100 + i * 400)).all()
    assert (d['snow_valid'].sum(1) == int(50 + i * 150)).all()
    bf = d['night_brightness']
    assert 1 - 0.3 * 0.6 <= bf.min() and bf.max() <= 1 - 0.3 * 0.2
    assert bf.std() > 0                  # the factor is still drawn


def test_unknown_weather_raises():
    image = torch.zeros(8, 8, 3, dtype=torch.uint8)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match='Unknown weather type'):
        corruption.apply_weather_effect(image, 'hail', g)
    with pytest.raises(ValueError, match='Unknown weather type'):
        corruption.corrupt_batch_static(image[None], 'hail', g)
    assert corruption.apply_weather_effect(image, 'clean') is image
    with pytest.raises(ValueError, match='generator or draws'):
        corruption.apply_weather_effect(image, 'rain')
