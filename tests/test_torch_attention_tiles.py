"""The bf16 attention kernels' order of operations, on the CPU, against JAX.

In bf16, ``csrc/sr_attention.cu`` and ``csrc/sr_attention_bwd.cu`` run on
the tensor cores in an order the plain versions do not follow:

- keys in 64-key tiles, with an online row max and an f32 rescale of the
  running sum and output;
- P = 2^(s·c − running max), c = scale·log2 e, rounded to bf16 for the PV
  product, while l sums the unrounded p;
- backward: delta = rowsum(dO∘o)/l from pass 1's output; P = 2^(s·c − lse)
  with lse = max + log2 l; dS rounded to bf16 before dq and dk, P before
  dv; every sum in f32.

``tiled_forward`` and ``tiled_backward`` write that order out in plain
torch (test-only). They are held against JAX's ``sr_attention`` and its VJP
(the Pallas kernels in interpret mode) on bf16 inputs, at the tolerances
the port already uses: 3e-2 for the output (tests/test_torch_ops.py), 6e-2
of each gradient's scale for dq/dk/dv (chip_smoke.py's K6 check); and
against the port's plain versions at the same tolerances, which is what
chip_smoke.py holds the kernels to on the card. N and M are ragged (not
multiples of 64), so the masked tails are covered; a key ramp makes the
row max move from tile to tile.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.ops import attention as jattn
from awsegbench_torch.ops import attention

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TILE = 64
SHAPES = [(2, 100, 70, 32, False), (1, 130, 150, 64, False),
          (3, 77, 200, 32, True), (2, 64, 129, 32, True)]


@pytest.fixture(autouse=True)
def _f32_matmul():
    with jax.default_matmul_precision('float32'):
        yield


def _log2e_scale(scale):
    return torch.tensor(scale, dtype=torch.float32) * math.log2(math.e)


def _pass1(q, k, v, c):
    """The forward's tiles: running max of s·c, sum of the unrounded p, and
    the unnormalised output from bf16 P."""
    g, n, _ = q.shape
    mx = torch.full((g, n, 1), -math.inf)
    l = torch.zeros((g, n, 1))
    o = torch.zeros(q.shape)
    for t0 in range(0, k.shape[1], TILE):
        s = q @ k[:, t0:t0 + TILE].transpose(1, 2)
        mnew = torch.maximum(mx, s.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(mx - mnew)
        p = torch.exp2(s * c - mnew)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.bfloat16().float() @ v[:, t0:t0 + TILE]
        mx = mnew
    return mx, l, o


def tiled_forward(q, k, v, scale):
    """The bf16 forward kernel's order of operations (bf16 in, bf16 out)."""
    _, l, o = _pass1(q.float(), k.float(), v.float(), _log2e_scale(scale))
    return (o / l).bfloat16()


def tiled_backward(q, k, v, dout, scale):
    """The bf16 backward kernels' order of operations: (dq, dk, dv) in
    bf16."""
    q, k, v, do = (t.float() for t in (q, k, v, dout))
    c = _log2e_scale(scale)
    mx, l, o = _pass1(q, k, v, c)
    delta = (do * o).sum(-1, keepdim=True) / l
    lse = mx + torch.log2(l)
    dq = torch.zeros(q.shape)
    for t0 in range(0, k.shape[1], TILE):          # kernel 1, pass 2
        kt, vt = k[:, t0:t0 + TILE], v[:, t0:t0 + TILE]
        p = torch.exp2(q @ kt.transpose(1, 2) * c - lse)
        ds = p * (do @ vt.transpose(1, 2) - delta) * scale
        dq += ds.bfloat16().float() @ kt
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for i0 in range(0, q.shape[1], TILE):          # kernel 2, query tiles
        qi, doi = q[:, i0:i0 + TILE], do[:, i0:i0 + TILE]
        p = torch.exp2(qi @ k.transpose(1, 2) * c - lse[:, i0:i0 + TILE])
        ds = p * (doi @ v.transpose(1, 2) - delta[:, i0:i0 + TILE]) * scale
        dv += p.bfloat16().float().transpose(1, 2) @ doi
        dk += ds.bfloat16().float().transpose(1, 2) @ qi
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _inputs(g, n, m, d, ramp, seed=11):
    """bf16-exact f32 arrays q, k, v, dout; with ``ramp`` the keys grow
    along M, so the row max moves from tile to tile."""
    rng = np.random.default_rng(seed + n + m)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((g, n, d), (g, m, d), (g, m, d), (g, n, d)))
    if ramp:
        k *= np.linspace(0.2, 3.0, m, dtype=np.float32)[None, :, None]
    return [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in (q, k, v, do)]


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _scaled_err(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got.float().numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize('g,n,m,d,ramp', SHAPES)
def test_tiled_forward_matches_jax_bf16(g, n, m, d, ramp):
    q, k, v, _ = _inputs(g, n, m, d, ramp)
    got = tiled_forward(_bf16(q), _bf16(k), _bf16(v), d ** -0.5)
    want = jattn.sr_attention(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)), d ** -0.5,
                              interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize('g,n,m,d,ramp', SHAPES)
def test_tiled_backward_matches_jax_vjp_bf16(g, n, m, d, ramp):
    q, k, v, do = _inputs(g, n, m, d, ramp)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: jattn.sr_attention(
        a, b, c, scale, interpret=True),
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    got = tiled_backward(_bf16(q), _bf16(k), _bf16(v), _bf16(do), scale)
    for name, a, b in zip('qkv', got, want):
        assert a.dtype == torch.bfloat16
        err = _scaled_err(a, b.astype(jnp.float32))
        assert err <= 6e-2, f'd{name}: {err} of the gradient scale'


@pytest.mark.parametrize('g,n,m,d,ramp', SHAPES)
def test_tiled_order_matches_the_plain_versions(g, n, m, d, ramp):
    """What chip_smoke.py holds the kernels to on the card, here on the
    CPU: the kernels' order against the port's plain versions."""
    q, k, v, do = (_bf16(a) for a in _inputs(g, n, m, d, ramp))
    scale = d ** -0.5
    np.testing.assert_allclose(
        tiled_forward(q, k, v, scale).float().numpy(),
        attention.sr_attention_plain(q, k, v, scale).float().numpy(),
        rtol=3e-2, atol=3e-2)
    want = attention.sr_attention_backward_plain(q, k, v, do, scale)
    for name, a, b in zip('qkv', tiled_backward(q, k, v, do, scale), want):
        err = _scaled_err(a, b.float().numpy())
        assert err <= 6e-2, f'd{name}: {err} of the gradient scale'


@pytest.mark.parametrize('dtype,d,design', [
    (torch.bfloat16, 32, 'mma_bf16'), (torch.bfloat16, 64, 'mma_bf16'),
    (torch.float32, 32, 'simt_f32'), (torch.float32, 64, 'simt_f32')])
def test_design_by_dtype_and_head_dim(dtype, d, design):
    assert attention._design(dtype, d) == design
    assert design in attention.DESIGNS


@pytest.mark.parametrize('dtype,d,error', [
    (torch.bfloat16, 48, ValueError), (torch.float32, 16, ValueError),
    (torch.float16, 32, TypeError), (torch.float64, 64, TypeError)])
def test_design_refuses_what_no_kernel_takes(dtype, d, error):
    with pytest.raises(error):
        attention._design(dtype, d)
