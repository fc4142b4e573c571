"""The rest of the port's weather and ops API against the JAX package's, on
the CPU, on the same numpy inputs: the style transfer, ``convert_scale_abs``
and ``resize_nearest`` bit for bit; the filters, the percentile, the fog
density map (with a given depth), the single-image depth estimate and the
depth post-processing within 1e-5; ``synthetic_depth`` with JAX's noise fed
in, and at the level of its distribution with the port's own draws; the
augmentation pipeline's weather pick and style rate at the level of their
distributions, and its composition exactly. Then the package facades:
every JAX ``__all__`` name with a counterpart resolves in the port (those
without are named in the facade's docstring), and importing them pulls in
neither JAX nor the JAX package and builds no kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from awsegbench.ops import filters as jfilters
from awsegbench.ops import resize as jresize
from awsegbench.weather import augmentation as jaug
from awsegbench.weather import corruption as jcorr
from awsegbench.weather import depth as jdepth
from awsegbench_torch.ops import filters, resize
from awsegbench_torch.weather import augmentation, corruption, depth

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _image(seed, h=37, w=53):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize('alpha,beta', [(0.8, 30), (1.2, -10), (0.5, 0.5),
                                        (-1.5, 20), (0.4, -20)])
def test_convert_scale_abs_bit_equal(alpha, beta):
    img = np.concatenate([np.arange(256, dtype=np.uint8).reshape(16, 16),
                          _image(1, 16, 16)[..., 0]])[..., None]
    got = augmentation.convert_scale_abs(_t(img), alpha, beta)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jaug.convert_scale_abs(jnp.asarray(img),
                                                       alpha, beta)))


@pytest.mark.parametrize('weather', ['fog', 'rain', 'snow', 'night', 'clean'])
def test_style_transfer_bit_equal(weather):
    img = _image(2)
    got = augmentation.style_transfer(_t(img), weather)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jaug.style_transfer(jnp.asarray(img),
                                                    weather)))


NEAREST = [((7, 5), (3, 2)), ((10, 9), (10, 9)), ((4, 4), (9, 7)),
           ((13, 6), (5, 17)), ((31, 64), (16, 20))]


@pytest.mark.parametrize('in_hw,out_hw', NEAREST)
@pytest.mark.parametrize('kind', ['labels_hw', 'uint8_hwc', 'f32_nhwc'])
def test_resize_nearest_bit_equal(in_hw, out_hw, kind):
    rng = np.random.default_rng(3)
    if kind == 'labels_hw':
        x = rng.integers(0, 256, in_hw).astype(np.int32)
    elif kind == 'uint8_hwc':
        x = rng.integers(0, 256, (*in_hw, 3), dtype=np.uint8)
    else:
        x = rng.standard_normal((2, *in_hw, 3)).astype(np.float32)
    got = resize.resize_nearest(_t(x), out_hw)
    want = np.asarray(jresize.resize_nearest(jnp.asarray(x), out_hw))
    assert got.dtype == _t(x).dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == 'f32_nhwc':        # JAX's nearest is 'nearest-exact', not 'nearest'
        exact = F.interpolate(_t(x).permute(0, 3, 1, 2), size=out_hw,
                              mode='nearest-exact').permute(0, 2, 3, 1)
        np.testing.assert_array_equal(exact.numpy(), want)


def test_rgb_to_gray_cv_u8_bit_equal():
    img = _image(4)[None]
    np.testing.assert_array_equal(
        filters.rgb_to_gray_cv_u8(_t(img)).numpy(),
        np.asarray(jfilters.rgb_to_gray_cv_u8(jnp.asarray(img))))


def _gray(seed, shape=(2, 23, 41, 1)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize('ksize', [3, 5])
def test_box_filter(ksize):
    x = _gray(5, (2, 23, 41, 3))
    _close(filters.box_filter(_t(x), ksize),
           jfilters.box_filter(jnp.asarray(x), ksize))


def test_local_contrast():
    x = _gray(6)
    _close(filters.local_contrast(_t(x)),
           jfilters.local_contrast(jnp.asarray(x)))


def test_rgb_to_gray_cv():
    x = _gray(7, (2, 9, 11, 3))
    _close(filters.rgb_to_gray_cv(_t(x)),
           jfilters.rgb_to_gray_cv(jnp.asarray(x)))


@pytest.mark.parametrize('dilation', [1, 2])
def test_depthwise_conv3x3(dilation):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 13, 17, 3)).astype(np.float32)
    k = rng.standard_normal((3, 3, 1, 3)).astype(np.float32)
    _close(filters.depthwise_conv3x3(_t(x), _t(k), dilation),
           jfilters.depthwise_conv3x3(jnp.asarray(x), jnp.asarray(k),
                                      dilation))


@pytest.mark.parametrize('n,q', [(1, 95.0), (2, 50.0), (1001, 95.0),
                                 (7919, 95.0), (7919, 12.5), (40000, 99.9)])
def test_percentile(n, q):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = filters.percentile(_t(x).reshape(-1, 1), q)
    assert got.shape == ()
    _close(got, jfilters.percentile(jnp.asarray(x), q))


@pytest.mark.parametrize('u8', [True, False], ids=['uint8', 'float'])
def test_fog_density_map_given_depth(u8):
    img = _image(9, 48, 80)
    depth_map = np.random.default_rng(10).uniform(
        1.0, 100.0, (48, 80)).astype(np.float32)
    x = img if u8 else (img / 255.0).astype(np.float32)
    got = corruption.fog_density_map(_t(x), depth=_t(depth_map))
    want = jcorr.fog_density_map(jnp.asarray(x), jax.random.PRNGKey(0),
                                 depth=jnp.asarray(depth_map))
    assert got.shape == (48, 80) and got.dtype == torch.float32
    _close(got, want)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


def test_fog_density_map_synthetic_depth():
    """Without a depth: the port's own synthetic depth, drawn on the CPU
    from the generator; a valid density of the image's shape."""
    img = _image(11, 32, 48)
    g = torch.Generator().manual_seed(0)
    got = corruption.fog_density_map(_t(img), generator=g)
    assert got.shape == (32, 48) and torch.isfinite(got).all()
    assert 0.0 <= float(got.min()) < float(got.max()) <= 1.0
    again = corruption.fog_density_map(
        _t(img), generator=torch.Generator().manual_seed(0))
    assert torch.equal(got, again)


def test_synthetic_depth_with_jax_noise():
    h, w = 40, 56
    key = jax.random.PRNGKey(12)
    noise = jax.random.normal(key, (h, w), jnp.float32) * 10.0
    got = corruption.synthetic_depth(h, w, noise=_t(noise))
    _close(got, jcorr.synthetic_depth(key, h, w))
    batched = corruption.synthetic_depth(h, w, noise=_t(noise)[None].repeat(
        2, 1, 1))
    assert batched.shape == (2, h, w) and torch.equal(batched[1], got)


def test_synthetic_depth_distribution():
    """The port's own draws against JAX's, by their statistics: the row
    means follow y/h·100 (floored at 1), and the blurred noise around them
    has JAX's spread."""
    h, w, n = 64, 128, 8
    ours = torch.stack([corruption.synthetic_depth(
        h, w, torch.Generator().manual_seed(s), device='cpu')
        for s in range(n)]).numpy()
    theirs = np.stack([np.asarray(jcorr.synthetic_depth(
        jax.random.PRNGKey(s), h, w)) for s in range(n)])
    assert ours.min() >= 1.0
    base = np.maximum(np.arange(h, dtype=np.float32)[:, None] / h * 100.0, 1)
    for d in (ours, theirs):
        np.testing.assert_allclose(d.mean(axis=(0, 2))[8:-8],
                                   base[8:-8, 0], atol=1.0)
    s_ours = (ours - base)[:, 8:-8].std()
    s_theirs = (theirs - base)[:, 8:-8].std()
    assert abs(s_ours - s_theirs) < 0.1 * s_theirs, (s_ours, s_theirs)


@pytest.mark.parametrize('hw', [(48, 80), (37, 53)])
def test_estimate_depth(hw):
    img = _image(13, *hw)
    got = depth.estimate_depth(_t(img))
    assert got.shape == hw
    _close(got, jdepth.estimate_depth(jnp.asarray(img)))


def test_depth_to_disparity():
    d = np.random.default_rng(14).uniform(0, 2, (9, 13)).astype(np.float32)
    d[0, :3] = [0.0, 1e-8, -1.0]
    _close(depth.depth_to_disparity(_t(d)), jdepth.depth_to_disparity(
        jnp.asarray(d)))
    _close(depth.depth_to_disparity(_t(d), 0.3), jdepth.depth_to_disparity(
        jnp.asarray(d), 0.3))


@pytest.mark.parametrize('target', [(24, 40), (48, 80), (96, 160), (17, 131)],
                         ids=['down', 'same', 'up', 'mixed'])
def test_preprocess_depth_for_training(target):
    d = np.random.default_rng(15).uniform(0, 50, (48, 80)).astype(np.float32)
    got = depth.preprocess_depth_for_training(_t(d), target)
    assert got.shape == target
    _close(got, jdepth.preprocess_depth_for_training(jnp.asarray(d), target))


def test_resize_linear_matches_jax_both_ways():
    x = np.random.default_rng(16).random((2, 30, 44, 3)).astype(np.float32)
    for out_hw in ((11, 44), (30, 13), (61, 20)):
        want = jax.image.resize(jnp.asarray(x), (2, *out_hw, 3), 'linear')
        _close(resize.resize_linear(_t(x), out_hw), want)


def test_augmentation_pick_and_style_rate(monkeypatch):
    """Over many generators: the weather uniform over the keys, the style
    applied with probability ``style_transfer_prob``."""
    picked = []
    monkeypatch.setattr(augmentation, 'apply_weather_effect',
                        lambda img, name, **kw: picked.append(name) or img)
    monkeypatch.setattr(augmentation, 'style_transfer',
                        lambda img, name: img + 1)
    pipe = augmentation.WeatherAugmentationPipeline(style_transfer_prob=0.3)
    img = torch.zeros((2, 2, 3), dtype=torch.uint8)
    n = 2000
    styled = sum(int(pipe.apply_domain_adaptation_augmentation(
        img, torch.Generator().manual_seed(s)).max()) for s in range(n))
    counts = {k: picked.count(k) for k in augmentation.DEFAULT_INTENSITIES}
    assert sum(counts.values()) == n
    # 4σ bounds of the binomial counts
    assert all(abs(c - n / 4) < 4 * (n * 0.25 * 0.75) ** 0.5
               for c in counts.values()), counts
    assert abs(styled - 0.3 * n) < 4 * (n * 0.3 * 0.7) ** 0.5, styled


@pytest.mark.parametrize('weather', ['fog', 'rain', 'snow', 'night'])
def test_augmentation_composition(weather):
    """The pipeline is the weather at its fixed intensity, from the
    generator's draws after the pick and the style draw, then the style
    transfer; the JAX pipeline's defaults are the same."""
    assert augmentation.DEFAULT_INTENSITIES == jaug.DEFAULT_INTENSITIES
    img = _t(_image(17, 24, 40))
    pipe = augmentation.WeatherAugmentationPipeline(style_transfer_prob=1.0)
    got = pipe.apply_domain_adaptation_augmentation(
        img, torch.Generator().manual_seed(5), target_weather=weather)
    g = torch.Generator().manual_seed(5)
    torch.randint(4, (), generator=g)
    torch.rand((), generator=g)
    want = augmentation.style_transfer(corruption.apply_weather_effect(
        img, weather, generator=g,
        intensity=augmentation.DEFAULT_INTENSITIES[weather]), weather)
    assert torch.equal(got, want) and not torch.equal(got, img)


# The package facades: JAX's ``__all__`` names that the port has no
# counterpart for (each named in the facade's docstring), and one renamed.
NO_COUNTERPART = {
    '': {'_JAX_AVAILABLE', '_TORCH_AVAILABLE'},
    'core': {'batch_sharding', 'replicated_sharding', 'per_sample_keys',
             'setup_compilation_cache'},
    'train': {'TrainState'},
    'utils': {'PhaseTimers'},
}
RENAMED = {'ops': {'sr_attention_reference': 'sr_attention_plain'}}
FACADES = ('', 'core', 'data', 'eval', 'losses', 'metrics', 'models', 'ops',
           'parallel', 'train', 'utils', 'weather')


@pytest.mark.parametrize('sub', FACADES, ids=[s or 'top' for s in FACADES])
def test_facade_exports_the_jax_names(sub):
    import importlib
    jmod = importlib.import_module('.'.join(filter(None, ('awsegbench', sub))))
    mod = importlib.import_module('.'.join(filter(None, ('awsegbench_torch',
                                                         sub))))
    missing = NO_COUNTERPART.get(sub, set())
    assert missing <= set(jmod.__all__)
    for name in missing:
        assert name in mod.__doc__, name
    for name in set(jmod.__all__) - missing:
        name = RENAMED.get(sub, {}).get(name, name)
        assert name in mod.__all__ and hasattr(mod, name), name
    assert all(hasattr(mod, name) for name in mod.__all__)


def test_facades_import_no_jax_and_build_no_kernel():
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = f'''
import importlib, sys
sys.path.insert(0, {str(root)!r})
for sub in {FACADES!r}:
    importlib.import_module('.'.join(filter(None, ('awsegbench_torch', sub))))
from awsegbench_torch import _build
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'awsegbench'))
print(bad, sorted(_build._libs), sorted(_build.build_log))
'''
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300, cwd=root)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split('\n')[-2] == '[] [] []', r.stdout
