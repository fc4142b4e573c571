"""The port's ops (``awsegbench_torch/ops``) against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both. The JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them; the
port's wrappers take their plain PyTorch versions because the tensors lie on
the CPU. Tolerances: 1e-5 for f32 ops (the JAX package's own op tolerance),
3e-2 for bf16 attention (as tests/test_attention.py), one bf16 step for the
bf16 seg head at r = 32 and exact below, exact for
the splat mask and the uint8 gray conversion.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from awsegbench.ops import attention as jattn
from awsegbench.ops import filters as jfilt
from awsegbench.ops import headkernels as jhead
from awsegbench.ops import resize as jresize
from awsegbench.ops import splat as jsplat
from awsegbench.ops import upconv as jup
from awsegbench.weather import corruption as jcorr
from awsegbench_torch import _build
from awsegbench_torch.ops import attention, filters, headkernels, \
    headkernels_train, resize, splat, upconv

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(autouse=True)
def _f32_matmul():
    with jax.default_matmul_precision('float32'):
        yield


@pytest.mark.parametrize('shape,out_hw', [((2, 4, 8, 5), (16, 32)),
                                          ((1, 3, 5, 2), (12, 13)),
                                          ((2, 16, 32, 3), (64, 128))])
def test_upsample_like(shape, out_hw):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _close(resize.upsample_like(torch.from_numpy(x), out_hw),
           jresize.upsample_like(jnp.asarray(x), out_hw), 1e-5)


def test_resize_refuses_downsampling():
    with pytest.raises(ValueError):
        resize.resize_bilinear(torch.zeros(1, 8, 8, 1), (4, 8))


@pytest.mark.parametrize('ksize,sigma', [(3, 0.5), (3, 1.0), (7, 1.0)])
def test_gaussian_blur_cv(ksize, sigma):
    x = np.random.default_rng(1).random((2, 20, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(filters.gaussian_kernel1d_cv(ksize, sigma),
                                  jfilt.gaussian_kernel1d_cv(ksize, sigma))
    _close(filters.gaussian_blur_cv(torch.from_numpy(x), ksize, sigma),
           jfilt.gaussian_blur_cv(jnp.asarray(x), ksize, sigma), 1e-5)


@pytest.mark.parametrize('sigma', [1.0, 2.0])
def test_gaussian_filter_scipy(sigma):
    x = np.random.default_rng(2).standard_normal((2, 18, 21, 1)).astype(
        np.float32) * 10
    np.testing.assert_array_equal(filters.gaussian_kernel1d_scipy(sigma),
                                  jfilt.gaussian_kernel1d_scipy(sigma))
    _close(filters.gaussian_filter_scipy(torch.from_numpy(x), sigma),
           jfilt.gaussian_filter_scipy(jnp.asarray(x), sigma), 1e-5)


@pytest.mark.parametrize('mode', ['reflect', 'symmetric'])
def test_border_modes_match_numpy(mode):
    x = np.arange(2 * 5 * 6).reshape(1, 5, 6, 2).astype(np.float32)
    for axis in (1, 2):
        pads = [(0, 0)] * 4
        pads[axis] = (3, 3)
        np.testing.assert_array_equal(
            filters.pad_axis(torch.from_numpy(x), axis, 3, mode).numpy(),
            np.pad(x, pads, mode=mode))


def test_laplacian_and_gray():
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (2, 17, 19, 3), dtype=np.uint8)
    gray = filters.rgb_to_gray_cv_u8(torch.from_numpy(u8))
    np.testing.assert_array_equal(gray.numpy(), np.asarray(
        jfilt.rgb_to_gray_cv_u8(jnp.asarray(u8))))
    g = gray.float()
    _close(filters.laplacian(g), jfilt.laplacian(jnp.asarray(g.numpy())),
           1e-5)


@pytest.mark.parametrize('h,w,cin,cout,r', [(3, 4, 6, 5, 4), (2, 3, 4, 8, 8),
                                            (1, 2, 3, 2, 32)])
def test_upsample_conv3x3(h, w, cin, cout, r):
    rng = np.random.default_rng(4)
    f = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    got = upconv.upsample_conv3x3(torch.from_numpy(f), torch.from_numpy(k),
                                  torch.from_numpy(b), scale=r)
    _close(got, jup.upsample_conv3x3(jnp.asarray(f), jnp.asarray(k),
                                     jnp.asarray(b), scale=r), 1e-5)
    # and the literal interpolate-then-conv it replaces
    up = F.interpolate(torch.from_numpy(f).permute(0, 3, 1, 2),
                       size=(h * r, w * r), mode='bilinear',
                       align_corners=False)
    lit = F.conv2d(up, torch.from_numpy(k).permute(3, 2, 0, 1),
                   torch.from_numpy(b), padding=1).permute(0, 2, 3, 1)
    _close(got, lit.numpy(), 1e-5)


def test_shift_gather_negative_axis():
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    for neg in (-1, -2, -3):
        assert torch.equal(upconv._shift_gather(x, neg),
                           upconv._shift_gather(x, x.ndim + neg))
    got = upconv._shift_gather(x, -1)
    assert got.shape == (2, 3, 4, 3)
    assert torch.equal(got[..., 1:3, 0], x[..., 0:2])   # i−1
    assert torch.equal(got[..., 0, 0], x[..., 0])       # clamped


@pytest.mark.parametrize('g,n,m,d', [(2, 64, 16, 32), (3, 130, 70, 32),
                                     (2, 100, 64, 64)])
def test_sr_attention_f32(g, n, m, d):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((g, n, d), (g, m, d), (g, m, d)))
    got = attention.sr_attention(*map(torch.from_numpy, (q, k, v)), d ** -0.5)
    want = jattn.sr_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              d ** -0.5, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_sr_attention_bf16():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 96, 32), (2, 48, 32), (2, 48, 32)))
    got = attention.sr_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 0.176)
    assert got.dtype == torch.bfloat16
    want = jattn.sr_attention(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)), 0.176, interpret=True)
    _close(got, np.asarray(want.astype(jnp.float32)), 3e-2)


def _seg_inputs(h, w, cin, c1, nc, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, h, w, cin)).astype(np.float32),
            (rng.standard_normal((3, 3, cin, c1)) * 0.2).astype(np.float32),
            (rng.standard_normal(c1) * 0.1).astype(np.float32),
            rng.uniform(0.5, 1.5, c1).astype(np.float32),
            (rng.standard_normal(c1) * 0.1).astype(np.float32),
            (rng.standard_normal(c1) * 0.1).astype(np.float32),
            rng.uniform(0.5, 2.0, c1).astype(np.float32),
            (rng.standard_normal((1, 1, c1, nc)) * 0.2).astype(np.float32),
            (rng.standard_normal(nc) * 0.1).astype(np.float32)]


@pytest.mark.parametrize('h,w,cin,c1,nc,r', [(3, 4, 8, 16, 19, 8),
                                             (2, 2, 4, 16, 5, 4),
                                             (1, 3, 8, 32, 19, 32)])
def test_seg_head_fused(h, w, cin, c1, nc, r):
    f, k1, b1, bs, bo, bm, bv, kp, bp = _seg_inputs(h, w, cin, c1, nc)
    t = [torch.from_numpy(a) for a in (f, k1, b1, bs, bo, bm, bv, kp, bp)]
    got = headkernels.seg_head_fused(*t[:7], 1e-5, *t[7:], scale=r)
    j = [jnp.asarray(a) for a in (f, k1, b1, bs, bo, bm, bv, kp, bp)]
    want = jhead.seg_head_fused(*j[:7], 1e-5, *j[7:], scale=r,
                                interpret=True)
    assert got.shape == (2, h * r, w * r, nc)
    _close(got, want, 1e-5)


def test_seg_head_tables_factor_the_kron_table():
    for r in (4, 8, 32):
        np.testing.assert_array_equal(headkernels._ayx(r), jhead._ayx(r, False))


@pytest.mark.parametrize('h,w,cin,c1,r,seed', [(2, 3, 8, 16, 8, 8),
                                               (1, 3, 8, 32, 32, 7)])
def test_seg_head_bf16_against_jax(h, w, cin, c1, r, seed):
    """bf16 operands, f32 sums, hidden rounded to bf16 before the 1×1, and
    the phase passes as one product against kron(Ay, Ax) with its products
    rounded to bf16, as the Pallas body: within one bf16 step of the
    pixel's largest |logit| of JAX's head (the sums run in another order),
    and bit-equal up to r = 8."""
    f, k1, b1, bs, bo, bm, bv, kp, bp = _seg_inputs(h, w, cin, c1, 19,
                                                    seed=seed)
    t = [torch.from_numpy(a) for a in (f, k1, b1, bs, bo, bm, bv, kp, bp)]
    got = headkernels.seg_head_fused(t[0].bfloat16(), t[1].bfloat16(),
                                     *t[2:7], 1e-5, t[7].bfloat16(), t[8],
                                     scale=r)
    assert got.dtype == torch.bfloat16
    j = [jnp.asarray(a) for a in (f, k1, b1, bs, bo, bm, bv, kp, bp)]
    want = np.asarray(jhead.seg_head_fused(
        j[0].astype(jnp.bfloat16), j[1].astype(jnp.bfloat16), *j[2:7], 1e-5,
        j[7].astype(jnp.bfloat16), j[8], scale=r,
        interpret=True).astype(jnp.float32))
    if r <= 8:
        np.testing.assert_array_equal(_np(got), want)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max(-1, keepdims=True)))
                   - 7)
    assert (np.abs(_np(got) - want) <= step).all()


def _capsules(b, n, h, w, seed):
    rng = np.random.default_rng(seed)
    ax = rng.integers(0, w, (b, n)).astype(np.float32)
    ay = rng.integers(0, h, (b, n)).astype(np.float32)
    bx = np.clip(np.trunc(ax + rng.uniform(-20, 20, (b, n))), 0, w - 1)
    by = np.clip(np.trunc(ay + rng.uniform(0, 20, (b, n))), 0, h - 1)
    r = rng.choice([0.5, 1.5, 1.0, 4.0], (b, n)).astype(np.float32)
    circle = rng.random((b, n)) < 0.3          # snow: zero-length capsules
    bx = np.where(circle, ax, bx).astype(np.float32)
    by = np.where(circle, ay, by).astype(np.float32)
    valid = np.arange(n)[None] < rng.integers(0, n, (b, 1))
    return ax, ay, bx, by, r, valid


def test_splat_mask_bit_exact():
    b, n, h, w = 3, 500, 64, 256
    caps = _capsules(b, n, h, w, seed=9)
    params = splat.pack_params(*(torch.from_numpy(np.asarray(c))
                                 for c in caps))
    got = splat.splat_coverage_batched(params, h, w).numpy()
    j = [jnp.asarray(c) for c in caps]
    scan = np.stack([np.asarray(jcorr._segment_coverage(
        h, w, *(c[i] for c in j))) for i in range(b)])
    nv, prm, winpos = jax.vmap(lambda *a: jsplat.prepare_splat_batch(
        *a, h, w))(*j)
    pallas = np.asarray(jsplat.splat_coverage_batched(
        nv, prm, winpos, h, w, interpret=True)) > 0.5
    assert got.dtype == np.float32 and got.any()
    np.testing.assert_array_equal(got > 0.5, scan)
    np.testing.assert_array_equal(got > 0.5, pallas)


def test_cpu_calls_do_not_count_launches():
    before = (dict(_build.launches), dict(_build.design_launches))
    attention.sr_attention(torch.zeros(1, 4, 32), torch.zeros(1, 2, 32),
                           torch.zeros(1, 2, 32), 1.0)
    attention.sr_attention_backward(
        *(torch.zeros(1, r, 32, dtype=torch.bfloat16) for r in (4, 2, 2, 4)),
        1.0)
    for fn in (attention.sr_attention, attention.sr_attention_backward):
        assert _build.launches[fn.__name__] == 0
        assert not any(_build.design_launches[fn.__name__, d]
                       for d in attention.DESIGNS)
    headkernels.seg_core(torch.zeros(1, 1, 1, 9, 16), torch.ones(16),
                         torch.zeros(16), torch.zeros(16, 19), torch.zeros(19),
                         4)
    headkernels_train.seg_core_train(
        torch.zeros(1, 1, 1, 9, 16, dtype=torch.bfloat16), torch.ones(16),
        torch.zeros(16), torch.zeros(16, 5), torch.zeros(5),
        torch.tensor(3, dtype=torch.int32), 0.1, 4)
    splat.splat_coverage_batched(torch.zeros(1, 2, 8), 8, 8)
    assert before == ({}, {})
    assert not _build.launches and not _build.design_launches


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / 'awsegbench_torch').rglob('*.py'))
    files.append(REPO / 'chip_smoke.py')
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split('.')[0]
            assert top not in ('jax', 'jaxlib', 'flax', 'awsegbench'), \
                f'{path.relative_to(REPO)} imports {name}'
