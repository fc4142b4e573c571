"""The port's train-mode depth head against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both. JAX's
``depth_stage1_fused_train`` runs its Pallas kernels in interpret mode; the
port's wrappers take their plain PyTorch versions (and plain autograd)
because the tensors lie on the CPU. The depth head module runs unfused in
JAX on the CPU, with Flax ``nn.Dropout``, whose stream torch cannot
reproduce: ``flax.linen.intercept_methods`` gives it the counter-hash mask
the port draws from the same seed (test code only).

Tolerances, as tests/test_depthkernels_train.py holds the TPU kernels: h2
and the batch statistics within rtol/atol 1e-4; the gradients of f, both
kernels, gamma and beta through a BN2/ReLU/1×1/sigmoid tail within rtol 2e-3
and atol 3e-5·max(scale, 1); bf16 within 0.05 of the output's scale; the
dropout masks bit-equal.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.models.heads import DepthEstimationHead as JHead
from awsegbench.ops import depthkernels_train as jdk
from awsegbench_torch import _build
from awsegbench_torch.convert import flax_to_torch, torch_to_flax
from awsegbench_torch.models.heads import DepthEstimationHead
from awsegbench_torch.ops import depthkernels_train as dk
from awsegbench_torch.ops.headkernels import _neighbor_pp
from awsegbench_torch.ops.headkernels_train import _neighbor_pp_adjoint

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-5


@pytest.fixture(autouse=True)
def _f32_matmul():
    with jax.default_matmul_precision('float32'):
        yield


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _stage1_args(rng, h, w, cin, c1, c2, b=2):
    """f, conv1 kernel and bias, gamma, beta, conv2 kernel (f32 numpy)."""
    return [a.astype(np.float32) for a in (
        rng.standard_normal((b, h, w, cin)),
        rng.standard_normal((3, 3, cin, c1)) * 0.2,
        rng.standard_normal((c1,)) * 0.1,
        rng.uniform(0.5, 1.5, (c1,)),
        rng.standard_normal((c1,)) * 0.1,
        rng.standard_normal((3, 3, c1, c2)) * 0.2)]


def _tail_args(rng, c2):
    """conv2 bias, BN2 gamma and beta, the 1×1 kernel and bias."""
    return [a.astype(np.float32) for a in (
        rng.standard_normal((c2,)) * 0.1, rng.uniform(0.5, 1.5, (c2,)),
        rng.standard_normal((c2,)) * 0.1,
        rng.standard_normal((1, 1, c2, 1)) * 0.3,
        rng.standard_normal((1,)) * 0.1)]


def _jax_tail(h2, b2, g2, be2, kp, bp):
    xf = (h2 + b2).astype(jnp.float32)
    m2 = xf.mean((0, 1, 2))
    v2 = (xf * xf).mean((0, 1, 2)) - m2 * m2
    u2 = jax.nn.relu((xf - m2) * g2 * jax.lax.rsqrt(v2 + BN_EPS) + be2)
    return jax.nn.sigmoid(jnp.einsum('bhwc,co->bhwo', u2, kp[0, 0]) + bp)


def _torch_tail(h2, b2, g2, be2, kp, bp):
    xf = (h2 + b2).float()
    m2 = xf.mean((0, 1, 2))
    v2 = (xf * xf).mean((0, 1, 2)) - m2 * m2
    u2 = torch.relu((xf - m2) * g2 * torch.rsqrt(v2 + BN_EPS) + be2)
    return torch.sigmoid(u2 @ kp[0, 0] + bp)


@pytest.mark.parametrize('h,w,cin,c1,c2,r,rate,seed', [
    (3, 4, 8, 16, 12, 8, 0.0, 0),
    (3, 4, 8, 16, 12, 8, 0.3, 13),
    (2, 3, 6, 20, 10, 4, 0.1, -987654321),   # channels no multiple of 8
    (2, 2, 4, 8, 6, 4, 0.1, 7),              # the output is all border
])
def test_depth_stage1_matches_jax(h, w, cin, c1, c2, r, rate, seed):
    """h2 and BN1's batch statistics, and the gradients of every input
    through a BN2 → ReLU → 1×1 → sigmoid tail (both BN couplings)."""
    rng = np.random.default_rng(h * 100 + c1 + r)
    args = _stage1_args(rng, h, w, cin, c1, c2)
    tail = _tail_args(rng, c2)
    wsum = rng.standard_normal((2, h * r, w * r, 1)).astype(np.float32)

    def jloss(a):
        h2, m, v = jdk.depth_stage1_fused_train(
            *a[:5], BN_EPS, a[5], rate=rate, seed=seed, scale=r,
            interpret=True)
        return jnp.sum(_jax_tail(h2, *map(jnp.asarray, tail)) * wsum), \
            (h2, m, v)

    (_, (h2, m, v)), jg = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(a) for a in args])
    targs = [_t(a).requires_grad_() for a in args]
    th2, tm, tv = dk.depth_stage1_fused_train(
        *targs[:5], BN_EPS, targs[5], rate=rate,
        seed=torch.tensor(seed, dtype=torch.int32), scale=r)
    loss = (_torch_tail(th2, *map(_t, tail)) * _t(wsum)).sum()
    tg = torch.autograd.grad(loss, targs, materialize_grads=True)
    assert th2.shape == (2, h * r, w * r, c2)
    for got, want in ((th2, h2), (tm, m), (tv, v)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    names = ['f', 'conv1_kernel', 'conv1_bias', 'bn_scale', 'bn_bias',
             'conv2_kernel']
    for name, got, want in zip(names, tg, jg):
        if name == 'conv1_bias':    # zero by construction on both sides
            assert not got.any()
            continue
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=max(scale, 1.0) * 3e-5,
                                   err_msg=f'grad {name}')


def test_depth_stage1_bf16_against_jax():
    h, w, cin, c1, c2, r, rate, seed = 3, 4, 8, 16, 12, 8, 0.1, 5
    args = _stage1_args(np.random.default_rng(3), h, w, cin, c1, c2)
    bf = (0, 1, 5)                       # f and both kernels in bf16
    jargs = [jnp.asarray(a, jnp.bfloat16 if i in bf else jnp.float32)
             for i, a in enumerate(args)]
    targs = [_t(a).to(torch.bfloat16 if i in bf else torch.float32)
             for i, a in enumerate(args)]
    h2, m, v = jdk.depth_stage1_fused_train(
        *jargs[:5], BN_EPS, jargs[5], rate=rate, seed=seed, scale=r,
        interpret=True)
    th2, tm, tv = dk.depth_stage1_fused_train(
        *targs[:5], BN_EPS, targs[5], rate=rate,
        seed=torch.tensor(seed, dtype=torch.int32), scale=r)
    assert th2.dtype == torch.bfloat16
    want = np.asarray(h2.astype(jnp.float32))
    scale = float(np.abs(want).max())
    assert np.abs(th2.float().numpy() - want).max() < 0.05 * scale
    assert np.abs(tm.numpy() - np.asarray(m)).max() < 0.05
    assert np.abs(tv.numpy() - np.asarray(v)).max() < 0.05 * float(
        np.abs(np.asarray(v)).max())


def _core_case(r, rate, b=1, h=2, w=2, c=16):
    """bf16 P [b, h, w, 9, c], a1, c1, dd1 and the seed from numpy, and
    the same pp (chunk 1), a1, c1 and seed as JAX's core kernels take."""
    rng = np.random.default_rng(r + int(rate * 10))
    P = _t(rng.standard_normal((b, h, w, 9, c)).astype(np.float32)
           * 0.5).bfloat16()
    a1 = _t((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    c1 = _t((0.1 * rng.standard_normal(c)).astype(np.float32))
    dd1 = _t(rng.standard_normal((b, h * r, w * r, c)).astype(
        np.float32)).bfloat16()
    seed = 12345 + r
    pp = _neighbor_pp(P.reshape(b, h, w, 3, 3, c)).float().numpy()
    jargs = (jnp.asarray(pp, jnp.bfloat16), jnp.asarray(a1.numpy())[None],
             jnp.asarray(c1.numpy())[None], jnp.asarray([seed], jnp.int32),
             rate, r, h * r, w * r, True, c, 1)
    return (P, a1, c1, torch.tensor(seed, dtype=torch.int32), dd1), jargs


def _rel(got, want):
    want = np.asarray(want, np.float32).reshape(-1)
    got = got.float().numpy().reshape(-1)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('r', [4, 8, 32])
def test_d1_plain_forward_rounds_as_jax_bf16(r, rate):
    """In bf16, K9's plain version forms fine with the bf16 kron table, as
    JAX's ``_d1_fwd_kernel`` (interpret mode) does: d1 ≥ 99.9% bit-equal.
    With the exact f32 two-pass tables it read 81–85% at r = 32."""
    (P, a1, c1, seed, _), jargs = _core_case(r, rate)
    want = np.asarray(jdk._core_fwd_impl(*jargs).astype(jnp.float32))
    got = dk.d1_core_train_plain(P, a1, c1, seed, rate, r)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    share = float((got.float().numpy() == want).mean())
    assert share >= 0.999, f'{share} of d1 bit-equal'


@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('r', [4, 8, 32])
def test_d1_plain_backward_rounds_as_jax_bf16(r, rate):
    """K10's plain version against JAX's ``_d1_bwd_kernel`` (interpret
    mode) in bf16: da1 and dc1 within 1e-5 of their scale (they read 0.2%
    and 3–5% off at r = 32 before the plain versions used the bf16 kron
    table). dpp within 1e-2: autograd keeps dfine in f32 where the kernel
    rounds it to bf16 (``test_torch_seg_head_tiles.py`` holds that order
    bit for bit)."""
    (P, a1, c1, seed, dd1), jargs = _core_case(r, rate)
    dpp, da1, dc1 = jdk._core_bwd_impl(
        *jargs, jnp.asarray(dd1.float().numpy(), jnp.bfloat16))
    got = dk.d1_core_train_backward_plain(P, a1, c1, seed, dd1, rate, r)
    assert got[0].dtype == torch.bfloat16
    for name, g, want, tol in (('dpp', got[0], dpp.astype(jnp.float32), 1e-2),
                               ('da1', got[1], da1, 1e-5),
                               ('dc1', got[2], dc1, 1e-5)):
        assert _rel(g, want) <= tol, f'{name}: {_rel(g, want)} > {tol}'


@pytest.mark.parametrize('seed', [0, -123456789, 2 ** 31 - 1])
def test_d1_keep_mask_bit_equal_to_jax(seed):
    """The [B, H, W, 128] mask of the SegFormer depth head's hidden."""
    shape = (2, 16, 32, 128)
    want = np.asarray(jdk.dropout_keep_mask(shape, jnp.int32(seed), 0.1))
    got = dk.dropout_keep_mask(shape, torch.tensor(seed, dtype=torch.int32),
                               0.1).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.85 < got.mean() < 0.95


def test_d1_core_backward_plain_and_adjoint_match_autograd():
    """K10's plain version (dpp on the neighbourhood stack) scattered back by
    ``_neighbor_pp_adjoint`` equals autograd through the whole plain core,
    and K9's plain version drops at the keep rate."""
    rng = np.random.default_rng(8)
    b, h, w, c, r, rate = 2, 3, 4, 24, 4, 0.2
    P = _t(rng.standard_normal((b, h, w, 9, c)).astype(np.float32))
    a1, c1 = (_t(rng.standard_normal(c).astype(np.float32)) for _ in range(2))
    dd1 = _t(rng.standard_normal((b, h * r, w * r, c)).astype(np.float32))
    seed = torch.tensor(4, dtype=torch.int32)
    ins = [t.clone().requires_grad_() for t in (P, a1, c1)]
    out = dk.d1_core_train(*ins, seed, rate, r)
    assert out.shape == (b, h * r, w * r, c)
    want = torch.autograd.grad(out, ins, dd1)
    dpp, da1, dc1 = dk.d1_core_train_backward(P, a1, c1, seed, dd1, rate, r)
    assert dpp.shape == (b, h, w, 81, c)
    for got, ref in zip([_neighbor_pp_adjoint(dpp), da1, dc1], want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # every dropped element is zero, at the keep rate
    keep = dk.dropout_keep_mask((b, h * r, w * r, c), seed, rate)
    assert torch.equal(out == 0, ~keep | (out == 0))
    assert 0.7 < keep.float().mean() < 0.9
    # the adjoint is the transpose of the gather (as for the seg core)
    y = torch.randn(b, h, w, 81, c, dtype=torch.float64)
    x = torch.randn(b, h, w, 9, c, dtype=torch.float64)
    lhs = (_neighbor_pp(x.reshape(b, h, w, 3, 3, c)) * y).sum()
    assert torch.allclose(lhs, (x * _neighbor_pp_adjoint(y).double()).sum())


def test_d1_kernel_wrappers_state_their_limits():
    """The CUDA wrappers check shapes before any build: r ≤ 32, nine taps."""
    P = torch.zeros(1, 2, 2, 9, 8)
    a = torch.zeros(8)
    seed = torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError, match='r ≤ 32'):
        dk._launch_forward(P, a, a, seed, 0.1, 33)
    with pytest.raises(ValueError, match='9, C'):
        dk._launch_backward(P[..., :4, :], a, a, seed,
                            torch.zeros(1, 8, 8, 8), 0.1, 4)
    with pytest.raises(TypeError, match='f32 or bf16'):
        dk._launch_forward(P.double(), a, a, seed, 0.1, 4)
    assert _build.launches['d1_core_train'] == 0
    assert _build.launches['d1_core_train_backward'] == 0


@pytest.mark.parametrize('shape,r', [
    ((2, 3, 4, 8), 8),       # fused: stage 1 through depth_stage1_fused_train
    ((2, 1, 3, 8), 8),       # one coarse row: the unfused upsample path
    ((2, 6, 10, 8), None),   # DeepLab's: no upsample, library convs
])
def test_depth_head_train_matches_jax(shape, r):
    """The module in train mode on its three paths, against JAX's head with
    the same weights, which takes its fused path only on the TPU: here JAX
    runs its unfused head with ``nn.Dropout`` given the hash mask. Output,
    gradients and both BNs' running statistics."""
    rng = np.random.default_rng(20 + shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    out_hw = (shape[1] * (r or 1), shape[2] * (r or 1))
    wsum = rng.standard_normal((2, *out_hw, 1)).astype(np.float32)
    seed = -31337
    jhead = JHead(hidden_channels=16)
    v = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x), upsample_scale=r)
    # non-trivial BN parameters and running stats
    v = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                        a.dtype), v)

    def dropout(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout):
            keep = jdk.dropout_keep_mask(args[0].shape, jnp.int32(seed), 0.1)
            return jnp.where(keep, args[0] / 0.9, 0.0)
        return next_fun(*args, **kwargs)

    def loss(p):
        with fnn.intercept_methods(dropout):
            y, mut = jhead.apply({'params': p, 'batch_stats': v['batch_stats']},
                                 jnp.asarray(x), train=True, upsample_scale=r,
                                 mutable=['batch_stats'])
        return jnp.sum(y * wsum), (y, mut['batch_stats'])

    (_, (y, stats)), grads = jax.value_and_grad(loss, has_aux=True)(
        v['params'])
    head = DepthEstimationHead(8, hidden_channels=16)
    head.load_state_dict(flax_to_torch(v))
    head.train()
    with pytest.raises(ValueError, match='seed'):
        head(_t(x), r)
    got = head(_t(x), r, torch.tensor(seed, dtype=torch.int32))
    (got * _t(wsum)).sum().backward()
    assert got.shape == (2, *out_hw, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-4, atol=1e-5)
    tgrads = torch_to_flax({n: p.grad if p.grad is not None
                            else torch.zeros_like(p)
                            for n, p in head.named_parameters()})['params']
    top = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(grads))
    for (path, want), got_g in zip(
            jax.tree_util.tree_leaves_with_path(grads),
            jax.tree_util.tree_leaves(tgrads)):
        scale = float(np.abs(np.asarray(want)).max())
        if scale < 1e-5 * top:      # conv biases before BN: zero analytically
            assert np.abs(got_g).max() < 1e-5 * top, path
            continue
        np.testing.assert_allclose(got_g, np.asarray(want), rtol=2e-3,
                                   atol=3e-5 * max(scale, 1.0),
                                   err_msg=str(path))
    tstats = torch_to_flax(dict(head.named_buffers()))['batch_stats']
    for bn in ('BatchNorm_0', 'BatchNorm_1'):
        for k in ('mean', 'var'):
            np.testing.assert_allclose(tstats[bn][k],
                                       np.asarray(stats[bn][k]),
                                       rtol=1e-4, atol=1e-5, err_msg=bn + k)
    # eval mode is unchanged: no dropout, running statistics, no seed
    head.eval()
    ev = head(_t(x), r)
    want = jhead.apply(jax.tree_util.tree_map(np.asarray, {
        'params': v['params'], 'batch_stats': tstats}), jnp.asarray(x),
        upsample_scale=r)
    np.testing.assert_allclose(ev.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
