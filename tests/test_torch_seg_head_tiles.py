"""The bf16 seg-head kernels' order of operations, on the CPU, against JAX.

In bf16, ``csrc/seg_head.cu`` (K2) and ``csrc/seg_head_train.cu`` (K7) run
``csrc/seg_head_mma.cuh`` on the tensor cores, per coarse cell:

- the phase passes as one product against the kron table, each entry the
  f32 product Ay[p, a]·Ax[q, b] rounded to bf16, its 81 columns padded to
  96 with zeros; f32 sums;
- affine, ReLU and (K7) the counter-hash dropout in f32, the hidden rounded
  to bf16 one 16-channel slice at a time;
- the 1×1 in f32, slice by slice, + bp, the logits rounded to bf16.

``tiled_core`` writes that order out in plain torch (test-only), from JAX's
phase tables and JAX's hash mask. It is held against JAX's
``seg_head_fused`` and ``seg_head_fused_train`` (the Pallas kernels in
interpret mode) on bf16 inputs, through the port's heads with their core
swapped for it, at one bf16 step of each output; an output that cancels
toward zero gets the floor of one bf16 step of the largest |logit| of its
pixel. The f32 sums run in another order than XLA's, so a hidden value on a
rounding boundary may flip by one step, and a logit with it; at least 99.9%
of the outputs must be bit-equal. It is also held against the port's plain
versions at chip_smoke.py's tolerance for the kernels on the card (6e-2).
Class counts 5 and 19, r ∈ {4, 8, 32}, ragged h and w, dropout rates 0
and 0.1.

K8 (the backward) recomputes fine in bf16 with the same kron table, on the
CUDA cores, through each pixel's 36 non-zero kron entries and per-ky slots
of pp (``bwd_kron``): ``k8_kron_order`` writes that indexing out for one
channel and holds it against the full 81-column table, for every r class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.ops import headkernels as jhead
from awsegbench.ops import headkernels_train as jht
from awsegbench_torch.ops import headkernels, headkernels_train
from awsegbench_torch.ops.headkernels import _neighbor_pp

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SLICE = 16      # channels per slice of the 1×1
K_PAD = 96      # the kron table's 81 columns, padded to 6 k-steps of 16
BN_EPS = 1e-5
CASES = [(2, 3, 5, 4), (3, 2, 19, 8), (2, 3, 19, 32), (2, 2, 5, 32)]


@pytest.fixture(autouse=True)
def _f32_matmul():
    with jax.default_matmul_precision('float32'):
        yield


def kron_bf16(r):
    """[r², 96]: Ay[p, k / 9]·Ax[q, k % 9] in f32, rounded to bf16, zero
    past column 81 (JAX's phase tables)."""
    ay, ax = jhead._a2(r, 0, r), jhead._a2_dmajor(r, 0, r)
    k = np.arange(81)
    tab = (ay[:, None, k // 9] * ax[None, :, k % 9]).reshape(r * r, 81)
    tab = torch.from_numpy(tab).bfloat16().float()
    return torch.nn.functional.pad(tab, (0, K_PAD - 81))


def tiled_core_train(P, a1, c1, wp, bp, seed, rate, r):
    """K7's bf16 order: P [B, h, w, 9, C] bf16 → logits [B, h·r, w·r, nc]
    bf16 (``seg_core_train``'s arguments)."""
    b, h, w, _, c = P.shape
    nc = wp.shape[1]
    pp = _neighbor_pp(P.reshape(b, h, w, 3, 3, c)).float()
    pp = torch.nn.functional.pad(pp, (0, 0, 0, K_PAD - 81))
    fine = torch.einsum('mk,bhwkc->bhwmc', kron_bf16(r), pp)  # [B,h,w,r²,C]
    keep = None
    if rate > 0.0:
        keep = np.asarray(jht.dropout_keep_mask(
            (b, h * r, w * r, c), jnp.int32(int(seed)), rate))
        keep = torch.from_numpy(keep).reshape(b, h, r, w, r, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, h, w, r * r, c)
    acc = torch.zeros(b, h, w, r * r, nc)
    for c0 in range(0, c, SLICE):
        s = slice(c0, c0 + SLICE)
        u = torch.relu(fine[..., s] * a1[s].float() + c1[s].float())
        if keep is not None:
            u = torch.where(keep[..., s], u * (1.0 / (1.0 - rate)), 0.0)
        acc += u.bfloat16().float() @ wp[s].bfloat16().float()
    out = (acc + bp.float()).bfloat16()
    return out.reshape(b, h, w, r, r, nc).permute(0, 1, 3, 2, 4, 5).reshape(
        b, h * r, w * r, nc)


def tiled_core(P, a1, c1, wp, bp, r):
    """K2's bf16 order (``seg_core``'s arguments): K7's without dropout."""
    return tiled_core_train(P, a1, c1, wp, bp, None, 0.0, r)


def bf16_step(x):
    """One bf16 step (unit in the last place) of each value; 0 at 0."""
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x.float()),
                                                e - 8))


def assert_within_one_step(got, want):
    """|got − want| ≤ one bf16 step of want, with the floor of one step of
    the largest |logit| of the pixel, and ≥ 99.9% bit-equal."""
    got, want = got.float(), torch.as_tensor(np.asarray(want, np.float32))
    floor = bf16_step(want.abs().amax(-1, keepdim=True))
    tol = torch.maximum(bf16_step(want), floor)
    err = (got - want).abs()
    assert bool((err <= tol).all()), \
        f'max excess over one bf16 step: {(err - tol).max().item()}'
    share = float((err == 0).float().mean())
    assert share >= 0.999, f'{share} of the outputs bit-equal'


def _head_inputs(h, w, cin, c1, nc, seed):
    """bf16-exact f32 arrays: f, conv1 kernel, conv1 bias, BN scale/bias/
    mean/var, proj kernel, proj bias."""
    rng = np.random.default_rng(seed)
    a = [rng.standard_normal((2, h, w, cin)),
         rng.standard_normal((3, 3, cin, c1)) * 0.2,
         rng.standard_normal(c1) * 0.1, rng.uniform(0.5, 1.5, c1),
         rng.standard_normal(c1) * 0.1, rng.standard_normal(c1) * 0.1,
         rng.uniform(0.5, 2.0, c1), rng.standard_normal((1, 1, c1, nc)) * 0.2,
         rng.standard_normal(nc) * 0.1]
    return [np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
            for x in a]


@pytest.mark.parametrize('h,w,nc,r', CASES)
def test_tiled_eval_head_matches_jax_bf16(h, w, nc, r, monkeypatch):
    f, k1, b1, bs, bo, bm, bv, kp, bp = _head_inputs(h, w, 8, 32, nc, r + nc)
    want = jhead.seg_head_fused(
        jnp.asarray(f, jnp.bfloat16), jnp.asarray(k1, jnp.bfloat16),
        *map(jnp.asarray, (b1, bs, bo, bm, bv)), BN_EPS,
        jnp.asarray(kp, jnp.bfloat16), jnp.asarray(bp), scale=r,
        interpret=True).astype(jnp.float32)
    monkeypatch.setattr(headkernels, 'seg_core', tiled_core)
    t = [torch.from_numpy(x) for x in (f, k1, b1, bs, bo, bm, bv, kp, bp)]
    got = headkernels.seg_head_fused(t[0].bfloat16(), t[1].bfloat16(),
                                     *t[2:7], BN_EPS, t[7].bfloat16(), t[8],
                                     scale=r)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert_within_one_step(got, want)


@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('h,w,nc,r', CASES)
def test_tiled_train_head_matches_jax_bf16(h, w, nc, r, rate, monkeypatch):
    f, k1, b1, bs, bo, _, _, kp, bp = _head_inputs(h, w, 8, 32, nc, r * nc)
    seed = -987654 + r
    want, _, _ = jht.seg_head_fused_train(
        jnp.asarray(f, jnp.bfloat16), jnp.asarray(k1, jnp.bfloat16),
        *map(jnp.asarray, (b1, bs, bo)), BN_EPS,
        jnp.asarray(kp, jnp.bfloat16), jnp.asarray(bp), rate=rate, seed=seed,
        scale=r, interpret=True)
    monkeypatch.setattr(headkernels_train, 'seg_core_train',
                        tiled_core_train)
    t = [torch.from_numpy(x) for x in (f, k1, b1, bs, bo, kp, bp)]
    got, _, _ = headkernels_train.seg_head_fused_train(
        t[0].bfloat16(), t[1].bfloat16(), *t[2:5], BN_EPS, t[5].bfloat16(),
        t[6], rate=rate, seed=torch.tensor(seed, dtype=torch.int32), scale=r)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert_within_one_step(got, want.astype(jnp.float32))


def _core_inputs(h, w, c, nc, seed):
    g = torch.Generator().manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    return ((randn(2, h, w, 9, c) * 0.5).bfloat16(), 1.0 + 0.1 * randn(c),
            0.1 * randn(c), (randn(c, nc) / 16).bfloat16(), 0.1 * randn(nc))


@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('h,w,nc,r', CASES)
def test_tiled_order_matches_the_plain_versions(h, w, nc, r, rate):
    """What chip_smoke.py holds the kernels to on the card, here on the
    CPU: the kernels' order against the port's plain versions (K2 at rate
    0, K7 at both)."""
    args = _core_inputs(h, w, 48, nc, seed=h * w * r)
    seed = torch.tensor(13579, dtype=torch.int32)
    got = tiled_core_train(*args, seed, rate, r)
    plains = [headkernels_train.seg_core_train_plain(*args, seed, rate, r)]
    if rate == 0.0:
        plains.append(headkernels.seg_core_plain(*args, r))
    for want in plains:
        assert want.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=6e-2,
                                   atol=6e-2)


@pytest.mark.parametrize('nc,ok', [(1, True), (19, True), (32, True),
                                   (33, False)])
def test_kernels_take_1_to_32_classes(nc, ok):
    P = torch.zeros(1, 2, 2, 9, 16, dtype=torch.bfloat16)
    args = (P, torch.zeros(16, nc), torch.ones(16), torch.zeros(16),
            torch.zeros(nc), 8, 'seg_core')
    if ok:
        assert headkernels.check_shapes(*args) == 'mma_bf16'
    else:
        with pytest.raises(ValueError, match='1 to 32 classes'):
            headkernels.check_shapes(*args)


@pytest.mark.parametrize('dtype,design', [(torch.bfloat16, 'mma_bf16'),
                                          (torch.float32, 'simt_f32')])
def test_design_by_dtype(dtype, design):
    assert headkernels._design(dtype) == design
    assert design in headkernels.DESIGNS
    with pytest.raises(TypeError):
        headkernels._design(torch.float16)


def _round_bf16(x):
    return float(torch.tensor(np.float32(x)).bfloat16())


def k8_kron_order(pp, df, r):
    """``bwd_kron``'s indexing for one channel, in f64: pp [81] → fine
    [r, r] through each pixel's 36 live kron entries; the pixels' df [r, r]
    → dpp [81] through the slots of each ky's two live coarse offsets."""
    ay, ax = headkernels._a2(r), headkernels._a2_dmajor(r)
    # the kernel runs each x pattern as one run of fine columns
    nxs = [sum(int(ax[q, kx] == 0) for kx in range(3)) for q in range(r)]
    assert nxs == sorted(nxs)
    sy0 = [int(ay[0, 3 * ky] == 0) for ky in range(3)]
    sy = list(sy0)
    rows = lambda a: slice(9 * a, 9 * a + 9)  # noqa: E731
    pps = [[pp[rows(3 * ky + sy[ky] + iy)].copy() for iy in (0, 1)]
           for ky in range(3)]
    dac = [[np.zeros(9) for _ in (0, 1)] for _ in range(3)]
    dpp = np.full(81, np.nan)
    fine = np.zeros((r, r))
    for p in range(r):
        for ky in range(3):
            if sy[ky] or ay[p, 3 * ky] != 0:
                continue
            sy[ky] = 1
            dpp[rows(3 * ky)] = dac[ky][0]
            pps[ky] = [pps[ky][1], pp[rows(3 * ky + 2)].copy()]
            dac[ky] = [dac[ky][1], np.zeros(9)]
        for q in range(r):
            nx = nxs[q]
            taps = []
            for ky in range(3):
                syk = int(ay[p, 3 * ky] == 0)
                for iy in (0, 1):
                    for ix in (0, 1):
                        for kx in range(3):
                            sxk = int(ax[q, kx] == 0)
                            t = _round_bf16(ay[p, 3 * ky + syk + iy]
                                            * ax[q, 3 * (sxk + ix) + kx])
                            bb = 3 * (int(kx >= 3 - nx) + ix) + kx
                            taps.append((t, ky, iy, bb))
            fine[p, q] = sum(t * pps[ky][iy][bb] for t, ky, iy, bb in taps)
            for t, ky, iy, bb in taps:
                dac[ky][iy][bb] += t * df[p, q]
    for ky in range(3):
        for iy in (0, 1):
            dpp[rows(3 * ky + sy[ky] + iy)] = dac[ky][iy]
        if not sy[ky]:
            dpp[rows(3 * ky + 2)] = 0.0
        elif sy0[ky]:
            dpp[rows(3 * ky)] = 0.0
    return fine, dpp


@pytest.mark.parametrize('r', [2, 3, 4, 5, 8, 17, 32])
def test_k8_kron_windows_hold_every_table_entry(r):
    """K8's 36-entry windows and slot shifts give the full bf16 kron
    product and its transpose."""
    rng = np.random.default_rng(r)
    pp, df = rng.standard_normal(81), rng.standard_normal((r, r))
    table = headkernels._ayx_bf16(r).double().numpy()          # [r², 81]
    fine, dpp = k8_kron_order(pp, df, r)
    assert not np.isnan(dpp).any()
    np.testing.assert_allclose(fine.reshape(-1), table @ pp, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(dpp, table.T @ df.reshape(-1), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize('nc,r', [(5, 32), (19, 8)])
def test_k8_plain_version_recomputes_the_forward_bf16(nc, r):
    """In bf16, K8's plain version (the reference of K8 on the card)
    differentiates the forward's own plain version: dP (scattered back),
    da1, dc1, dwp, dbp against autograd through ``seg_core_train_plain``
    within chip_smoke.py's 6e-2 of each gradient's scale."""
    args = _core_inputs(2, 3, 32, nc, seed=nc * r)
    seed = torch.tensor(-24680, dtype=torch.int32)
    dy = (torch.randn(2, 2 * r, 3 * r, nc,
                      generator=torch.Generator().manual_seed(r)) * 0.1
          ).bfloat16()
    ins = [t.detach().requires_grad_() for t in args]
    want = torch.autograd.grad(
        headkernels_train.seg_core_train_plain(*ins, seed, 0.1, r), ins, dy)
    dpp, *rest = headkernels_train.seg_core_train_backward_plain(
        *args, seed, dy, 0.1, r)
    got = [headkernels_train._neighbor_pp_adjoint(dpp), *rest]
    for name, g, w in zip(('P', 'a1', 'c1', 'wp', 'bp'), got, want):
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 6e-2 * scale, f'{name}: {err} > 6e-2 × {scale}'
