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

from awsegbench.ops import depthkernels_train as jdk
from awsegbench.ops import headkernels as jhead
from awsegbench.ops import headkernels_train as jht
from awsegbench_torch.ops import (depthkernels_train, headkernels,
                                  headkernels_train)
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


def _keep_cells(b, h, w, c, seed, rate, r):
    """JAX's keep mask in the cells' layout [B, h, w, r², C], or None."""
    if rate == 0.0:
        return None
    keep = np.asarray(jht.dropout_keep_mask((b, h * r, w * r, c),
                                            jnp.int32(int(seed)), rate))
    return torch.from_numpy(keep).reshape(b, h, r, w, r, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, h, w, r * r, c)


def tiled_bwd(P, a1, c1, wp, seed, dy, rate, r):
    """The bf16 backward body's order (``csrc/seg_bwd_mma.cuh``): K8 with
    the 1×1's weights wp and the logits' gradient dy, K10 with wp None and
    dy = dd1. Returns (dpp [B, h, w, 81, C] bf16, da1, dc1, dwp, dbp), the
    last two None for K10.

    fine is the forward's product (``tiled_core_train``: the bf16 kron
    table, K = 96); dv = bf16(dy)·bf16(wp)ᵀ and dwp = bf16(v)ᵀ·bf16(dy) in
    f32; dfine = dz·a1 rounded to bf16 before dpp = kronᵀ·dfine, rounded
    to bf16."""
    b, h, w, _, c = P.shape
    pp = _neighbor_pp(P.reshape(b, h, w, 3, 3, c)).float()
    pp = torch.nn.functional.pad(pp, (0, 0, 0, K_PAD - 81))
    tab = kron_bf16(r)                                   # [r², 96]
    fine = torch.einsum('mk,bhwkc->bhwmc', tab, pp)      # [B,h,w,r²,C]
    z = fine * a1.float() + c1.float()
    keep = _keep_cells(b, h, w, c, seed, rate, r)
    inv = 1.0 / (1.0 - rate)
    dropped = (lambda x: x) if keep is None else (  # noqa: E731
        lambda x: torch.where(keep, x * inv, 0.0))
    g = dy.float().reshape(b, h, r, w, r, -1).permute(0, 1, 3, 2, 4, 5)
    g = g.reshape(b, h, w, r * r, -1)
    dwp = dbp = None
    if wp is None:
        du = dropped(g)
    else:
        v = dropped(torch.relu(z)).bfloat16().float()
        du = dropped(g @ wp.bfloat16().float().T)
        dwp = torch.einsum('bhwmc,bhwmk->ck', v, g)
        dbp = g.sum((0, 1, 2, 3))
    dz = torch.where(z > 0, du, 0.0)
    da1, dc1 = (dz * fine).sum((0, 1, 2, 3)), dz.sum((0, 1, 2, 3))
    dfine = (dz * a1.float()).bfloat16().float()
    dpp = torch.einsum('mk,bhwmc->bhwkc', tab, dfine)[..., :81, :]
    return dpp.bfloat16(), da1, dc1, dwp, dbp


def _dwp_flip_room(P, a1, c1, dy, rate, r):
    """[C, nc]: what one hidden element rounding to bf16 the other way
    moves dwp[c, k] by, at most: one bf16 step of channel c's largest |v|
    times class k's largest |dy|. A fine value whose f32 sum, in another
    order, lands on the other side of a rounding boundary of v flips v by
    that step (one element of 393,216 at r = 32 here)."""
    b, h, w, _, c = P.shape
    pp = _neighbor_pp(P.reshape(b, h, w, 3, 3, c)).float()
    fine = torch.einsum('mk,bhwkc->bhwmc', kron_bf16(r)[:, :81], pp)
    v = torch.relu(fine * a1 + c1) / (1.0 - rate)
    vmax = v.abs().amax((0, 1, 2, 3))
    return bf16_step(vmax)[:, None] * dy.float().abs().amax((0, 1, 2))[None]


def _bwd_case(h, w, nc, r, rate, depth):
    """bf16 P, a1, c1, (K8) wp and bp, the seed and dy (K8) or dd1 (K10),
    from a numpy seed."""
    rng = np.random.default_rng(h * w * r + nc + depth)
    c = 32
    P = torch.from_numpy((rng.standard_normal((2, h, w, 9, c)) * 0.5)
                         .astype(np.float32)).bfloat16()
    a1 = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(
        np.float32))
    c1 = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    wp = torch.from_numpy((rng.standard_normal((c, nc)) / 16).astype(
        np.float32)).bfloat16()
    bp = torch.from_numpy((0.1 * rng.standard_normal(nc)).astype(np.float32))
    dy = torch.from_numpy((rng.standard_normal(
        (2, h * r, w * r, c if depth else nc)) * (1 if depth else 0.1))
        .astype(np.float32)).bfloat16()
    return P, a1, c1, wp, bp, -13579 + r, dy


def _jax_bwd(P, a1, c1, wp, bp, seed, dy, rate, r, depth):
    """JAX's backward kernels in interpret mode, on the same cells (chunk
    1): (dpp, da1, dc1, dwp, dbp) as numpy, the last two None for K10."""
    b, h, w, _, c = P.shape
    pp = jnp.asarray(_neighbor_pp(P.reshape(b, h, w, 3, 3, c)).float()
                     .numpy(), jnp.bfloat16)
    a1t, c1t = (jnp.asarray(t.numpy())[None] for t in (a1, c1))
    sd = jnp.asarray([seed], jnp.int32)
    g = jnp.asarray(dy.float().numpy(), jnp.bfloat16)
    if depth:
        out = jdk._core_bwd_impl(pp, a1t, c1t, sd, rate, r, h * r, w * r,
                                 True, c, 1, g)
        out = (*out, None, None)
    else:
        # wp's values are bf16 and the kernel rounds it to bf16 itself; in
        # f32 here, so _seg_core_bwd returns dwp in f32 (it casts dwp to
        # wp's dtype)
        res = (pp, a1t, c1t, jnp.asarray(wp.float().numpy()),
               jnp.asarray(bp.numpy()), sd, None)
        out = jht._seg_core_bwd(rate, r, h * r, w * r, True, res, g)[:5]
    return [None if x is None else np.asarray(
        jnp.asarray(x).astype(jnp.float32)).reshape(x.shape) for x in out]


def _assert_scaled(name, got, want, tol):
    want = np.asarray(want, np.float32).reshape(got.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol * scale, f'{name}: {err} > {tol} × {scale}'


@pytest.mark.parametrize('depth', [False, True], ids=['k8', 'k10'])
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('h,w,nc,r', CASES)
def test_tiled_backward_matches_jax_bf16(h, w, nc, r, rate, depth):
    """The backward body's order against JAX's ``_seg_core_bwd`` (K8) and
    ``_core_bwd_impl`` (K10) in interpret mode: dpp ≥ 99.9% bit-equal and
    the rest within one bf16 step; da1, dc1, dwp, dbp within 1e-5 of their
    scale (f32 sums in another order)."""
    P, a1, c1, wp, bp, seed, dy = _bwd_case(h, w, nc, r, rate, depth)
    got = tiled_bwd(P, a1, c1, None if depth else wp, seed, dy, rate, r)
    want = _jax_bwd(P, a1, c1, wp, bp, seed, dy, rate, r, depth)
    assert got[0].shape == want[0].shape
    assert_within_one_step(got[0], want[0])
    for name, g, wv in zip(('da1', 'dc1', 'dbp'), got[1:3] + got[4:],
                           want[1:3] + want[4:]):
        if wv is not None:
            _assert_scaled(name, g, wv, 1e-5)
    if not depth:   # dwp: 1e-5 of its scale, and room for one v flip
        err = (got[3] - torch.from_numpy(want[3])).abs()
        room = 1e-5 * float(np.abs(want[3]).max()) + _dwp_flip_room(
            P, a1, c1, dy, rate, r)
        assert bool((err <= room).all()), \
            f'dwp: max excess {(err - room).max().item()}'


@pytest.mark.parametrize('depth', [False, True], ids=['k8', 'k10'])
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('h,w,nc,r', CASES)
def test_tiled_backward_matches_the_plain_versions(h, w, nc, r, rate, depth):
    """What chip_smoke.py holds K8 and K10 to on the card, here on the CPU:
    the backward body's order against the port's plain versions within 6e-2
    of each gradient's scale."""
    P, a1, c1, wp, bp, seed, dy = _bwd_case(h, w, nc, r, rate, depth)
    st = torch.tensor(seed, dtype=torch.int32)
    got = tiled_bwd(P, a1, c1, None if depth else wp, st, dy, rate, r)
    if depth:
        want = depthkernels_train.d1_core_train_backward_plain(
            P, a1, c1, st, dy, rate, r)
    else:
        want = headkernels_train.seg_core_train_backward_plain(
            P, a1, c1, wp, bp, st, dy, rate, r)
    assert want[0].dtype == torch.bfloat16
    for name, g, wv in zip(('dpp', 'da1', 'dc1', 'dwp', 'dbp'), got, want):
        _assert_scaled(name, g, wv.float().numpy(), 6e-2)


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
