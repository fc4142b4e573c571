"""The port's train-mode ops against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both. The JAX Pallas
kernels run in interpret mode; the port's wrappers take their plain
PyTorch versions (and plain autograd) because the tensors lie on the CPU.

Tolerances: attention gradients rtol 2e-4 / atol 2e-5 (as
tests/test_attention.py holds the TPU kernel); the train seg head's
forward and batch statistics 1e-4, its gradients rtol 2e-3 and atol
max(scale, 1)·2e-5 (as tests/test_headkernels_train.py); the dropout masks
bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.ops import attention as jattn
from awsegbench.ops import headkernels_train as jht
from awsegbench_torch.ops import attention, headkernels_train as ht
from awsegbench_torch.ops.headkernels import _neighbor_pp

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


# ---------------------------------------------------------------- K6 path

@pytest.mark.parametrize('g,n,m,d', [(2, 64, 32, 32), (3, 100, 24, 64),
                                     (1, 37, 16, 32)])
def test_sr_attention_grads_match_jax(g, n, m, d):
    rng = np.random.default_rng(g * 100 + n)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((g, n, d), (g, m, d), (g, m, d), (g, n, d)))
    scale = d ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: jattn.sr_attention(
        a, b, c, scale, interpret=True), q, k, v)
    want = vjp(jnp.asarray(do))
    qkv = [_t(x).requires_grad_() for x in (q, k, v)]
    got_out = attention.sr_attention(*qkv, scale)
    got = torch.autograd.grad(got_out, qkv, _t(do))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=2e-4, atol=2e-5)
    for name, a, b in zip('qkv', got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5, err_msg=f'd{name}')
    # the backward wrapper's plain version gives the same
    for a, b in zip(attention.sr_attention_backward(*(_t(x) for x in (
            q, k, v, do)), scale), got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------- hash

@pytest.mark.parametrize('shape,seed,rate', [
    ((2, 8, 16, 16), 0, 0.1),
    ((3, 5, 7, 9), -123456789, 0.3),
    ((1, 32, 64, 8), 2 ** 31 - 1, 0.5),
    ((2, 4, 4, 256), -2 ** 31, 0.1),
])
def test_dropout_mask_bit_equal_to_jax(shape, seed, rate):
    want = np.asarray(jht.dropout_keep_mask(shape, jnp.int32(seed), rate))
    got = ht.dropout_keep_mask(shape, torch.tensor(seed, dtype=torch.int32),
                               rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.0 < got.mean() < 1.0
    B, H, W, C = shape
    for side in ('top', 'bot', 'left', 'right'):
        want = np.asarray(jht._line_mask(side, B, H, W, C, jnp.int32(seed),
                                         rate))
        got = ht._line_mask(side, B, H, W, C,
                            torch.tensor(seed, dtype=torch.int32), rate)
        np.testing.assert_array_equal(got.numpy(), want)


def test_core_params_match_jax():
    for rate in (0.0, 0.1, 0.3, 0.5, 1.0):
        assert ht._core_params(rate) == jht._core_params(rate)


# ---------------------------------------------------------------- K7/K8 path

def _head_args(rng, h, w, cin, c1, nc, b=2):
    return [rng.standard_normal((b, h, w, cin)),
            rng.standard_normal((3, 3, cin, c1)) * 0.2,
            rng.standard_normal((c1,)) * 0.1,
            rng.uniform(0.5, 1.5, (c1,)),
            rng.standard_normal((c1,)) * 0.1,
            rng.standard_normal((1, 1, c1, nc)) * 0.2,
            rng.standard_normal((nc,)) * 0.1]


@pytest.mark.parametrize('h,w,cin,c1,nc,r,rate,seed', [
    (3, 4, 8, 16, 7, 8, 0.1, 5),
    (2, 2, 4, 8, 3, 32, 0.1, -77),     # every cell is a border cell
    (2, 3, 6, 16, 19, 8, 0.0, 0),
])
def test_seg_head_fused_train_matches_jax(h, w, cin, c1, nc, r, rate, seed):
    rng = np.random.default_rng(h * 10 + r)
    args = [a.astype(np.float32) for a in _head_args(rng, h, w, cin, c1, nc)]
    wsum = rng.standard_normal((2, h * r, w * r, nc)).astype(np.float32)

    def jloss(a):
        f, k1, b1, s, o, wp, bp = a
        y, m, v = jht.seg_head_fused_train(
            f, k1, b1, s, o, BN_EPS, wp, bp, rate=rate, seed=seed, scale=r,
            interpret=True)
        return jnp.sum(y * wsum), (y, m, v)

    (_, (y, m, v)), jg = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(a) for a in args])
    targs = [_t(a).requires_grad_() for a in args]
    f, k1, b1, s, o, wp, bp = targs
    ty, tm, tv = ht.seg_head_fused_train(
        f, k1, b1, s, o, BN_EPS, wp, bp, rate=rate,
        seed=torch.tensor(seed, dtype=torch.int32), scale=r)
    tg = torch.autograd.grad((ty * _t(wsum)).sum(), targs,
                             materialize_grads=True)
    for got, want in ((ty, y), (tm, m), (tv, v)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    names = ['f', 'conv1_kernel', 'conv1_bias', 'bn_scale', 'bn_bias',
             'proj_kernel', 'proj_bias']
    for name, got, want in zip(names, tg, jg):
        if name == 'conv1_bias':    # zero by construction on both sides
            assert not got.any()
            continue
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=max(scale, 1.0) * 2e-5,
                                   err_msg=f'grad {name}')


def test_seg_core_backward_plain_and_adjoint_match_autograd():
    """K8's plain version (dpp on the neighbourhood stack) scattered back by
    ``_neighbor_pp_adjoint`` equals autograd through the whole plain core."""
    rng = np.random.default_rng(3)
    b, h, w, c, r, rate = 2, 3, 4, 16, 4, 0.2
    P = _t(rng.standard_normal((b, h, w, 9, c)).astype(np.float32))
    a1, c1 = (_t(rng.standard_normal(c).astype(np.float32)) for _ in range(2))
    wp = _t(rng.standard_normal((c, 19)).astype(np.float32))
    bp = _t(rng.standard_normal(19).astype(np.float32))
    dy = _t(rng.standard_normal((b, h * r, w * r, 19)).astype(np.float32))
    seed = torch.tensor(9, dtype=torch.int32)
    ins = [t.clone().requires_grad_() for t in (P, a1, c1, wp, bp)]
    out = ht.seg_core_train(*ins, seed, rate, r)
    want = torch.autograd.grad(out, ins, dy)
    dpp, *rest = ht.seg_core_train_backward(P, a1, c1, wp, bp, seed, dy,
                                            rate, r)
    assert dpp.shape == (b, h, w, 81, c)
    for got, ref in zip([ht._neighbor_pp_adjoint(dpp), *rest], want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # the adjoint is the transpose of the gather: <gather(x), y> = <x, adj(y)>
    y = torch.randn(b, h, w, 81, c, dtype=torch.float64)
    x = torch.randn(b, h, w, 9, c, dtype=torch.float64)
    lhs = (_neighbor_pp(x.reshape(b, h, w, 3, 3, c)) * y).sum()
    assert torch.allclose(lhs, (x * ht._neighbor_pp_adjoint(y).double()).sum())


def test_seg_batch_stats_match_materialized_hidden():
    """The coarse-domain sums equal those of the materialized hidden."""
    from awsegbench_torch.ops.headkernels import coarse_partial_products
    from awsegbench_torch.ops.upconv import (conv1_border_lines,
                                             upsample_conv3x3)
    rng = np.random.default_rng(4)
    f = _t(rng.standard_normal((2, 3, 5, 6)).astype(np.float32))
    k = _t((rng.standard_normal((3, 3, 6, 16)) * 0.3).astype(np.float32))
    r = 4
    s, q = ht.seg_batch_stats(coarse_partial_products(f, k), r,
                              conv1_border_lines(f, k, r))
    hidden = upsample_conv3x3(f, k, scale=r)
    torch.testing.assert_close(s, hidden.sum((0, 1, 2)), rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(q, (hidden * hidden).sum((0, 1, 2)),
                               rtol=1e-4, atol=1e-3)
