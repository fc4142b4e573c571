"""The kernels reached through their ``awseg::`` ops' autograd on the card.

* K6, K8 and K10 through the gradients registered on K1, K7 and K9
  (``ops/library.py``) give exactly what their direct launches give: K6's
  (dq, dk, dv); K8's and K10's dpp scattered by the adjoint kernel, and
  their column sums cast to the inputs' dtypes. f32 and bf16, one launch
  of each kernel per backward.
* The eval kernels (K2, K11, K12) raise when a call needs a gradient.

Needs a card: marked ``card`` and skipped without one. Run on the card with
``python -m pytest --noconftest -m card tests/test_torch_kernel_ops_card.py``.
This file imports no JAX.
"""

import pytest
import torch

from awsegbench_torch import _build
from awsegbench_torch.ops import attention, bn_act as bna, headkernels
from awsegbench_torch.ops import depthkernels_train as dk
from awsegbench_torch.ops import headkernels_train as ht
from awsegbench_torch.ops import ms_deform_attn as msda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


def _randn(dev, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator(dev).manual_seed(seed + sum(shape))
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _through_autograd(fn, args, grad, n):
    """The gradients of ``fn(*args)`` for ``grad`` with respect to the first
    ``n`` arguments, counted: (gradients, the launch table's counts)."""
    leaves = [a.detach().requires_grad_() if i < n else a
              for i, a in enumerate(args)]
    out = fn(*leaves)
    _build.launches.clear()
    grads = torch.autograd.grad(out, leaves[:n], grad)
    torch.cuda.synchronize()
    return grads, dict(_build.launches)


def _case(name, dev, dtype):
    """(gradients through the op's autograd, its counts, the same from the
    direct launches)."""
    if name == 'K6':
        q, dout = (_randn(dev, 8, 512, 32, dtype=dtype, seed=i)
                   for i in range(2))
        k, v = (_randn(dev, 8, 64, 32, dtype=dtype, seed=i) for i in (2, 3))
        got, counts = _through_autograd(attention.sr_attention,
                                        (q, k, v, 32 ** -0.5), dout, 3)
        want = attention._launch_backward(q, k, v, dout, 32 ** -0.5)
        return got, counts, want, {'sr_attention_backward': 1}
    P = _randn(dev, 2, 4, 6, 9, 32, dtype=dtype) * 0.5
    a1, c1 = _randn(dev, 32, seed=1), _randn(dev, 32, seed=2) * 0.1
    seed = torch.tensor([3, 0], dtype=torch.int32, device=dev)
    if name == 'K8':
        wp = _randn(dev, 32, 19, dtype=dtype, seed=3) / 8
        bp = _randn(dev, 19, seed=4)
        args = (P, a1, c1, wp, bp, seed, 0.1, 8)
        dy = _randn(dev, 2, 32, 48, 19, dtype=dtype, seed=5)
        got, counts = _through_autograd(ht.seg_core_train, args, dy, 5)
        dpp, sums = ht._launch_backward(*args[:6], dy, *args[6:])
        inputs = (a1, c1, wp, bp)
        op = 'seg_core_train_backward'
    else:
        args = (P, a1, c1, seed, 0.1, 8)
        dd1 = _randn(dev, 2, 32, 48, 32, dtype=dtype, seed=5)
        got, counts = _through_autograd(dk.d1_core_train, args, dd1, 3)
        dpp, sums = dk._launch_backward(*args[:4], dd1, *args[4:])
        inputs = (a1, c1)
        op = 'd1_core_train_backward'
    want = (ht._launch_pp_adjoint(dpp),
            *(g.to(t.dtype) for g, t in zip(ht.split_sums(sums, inputs),
                                             inputs)))
    return got, counts, want, {op: 1, 'neighbor_pp_adjoint': 1}


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name', ['K6', 'K8', 'K10'])
def test_backward_kernels_through_the_ops_equal_their_launches(card, name,
                                                               dtype):
    got, counts, want, launched = _case(name, card, dtype)
    torch.cuda.synchronize()
    assert counts == launched
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _eval_call(name, dev):
    """(the public function, its arguments, the index of one that takes a
    gradient)."""
    if name == 'K2':
        P = _randn(dev, 1, 2, 3, 9, 16, dtype=torch.bfloat16)
        return headkernels.seg_core, (
            P, _randn(dev, 16, seed=1), _randn(dev, 16, seed=2),
            _randn(dev, 16, 5, dtype=torch.bfloat16, seed=3),
            _randn(dev, 5, seed=4), 4), 0
    if name == 'K11':
        value = _randn(dev, 1, 4 * 6, 2, 8)
        loc = torch.rand((1, 5, 2, 1, 3, 2), device=dev)
        attn = torch.softmax(_randn(dev, 1, 5, 2, 1, 3), -1)
        return msda.ms_deform_attn, (value, [4, 6], loc, attn), 0
    x = _randn(dev, 2, 8, 3, 5)
    ch = [_randn(dev, 8, seed=i) for i in range(4)]
    ch[1] = ch[1].abs() + 0.1
    return bna.bn_act, (x, *ch, 1e-5, None, True), 0


@pytest.mark.card
@pytest.mark.parametrize('name', ['K2', 'K11', 'K12'])
def test_eval_kernels_raise_under_a_gradient(card, name):
    fn, args, i = _eval_call(name, card)
    args = list(args)
    with torch.no_grad():
        fn(*args)                             # the eval call launches
    args[i] = args[i].detach().requires_grad_()
    with pytest.raises(NotImplementedError, match='eval only'):
        fn(*args)
