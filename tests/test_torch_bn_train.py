"""Train-mode BN with its residual add and ReLU as one op with a registered
gradient (``ops/bn_train.py``: K13's and K14's plain versions and the
custom ops ``awseg::bn_train``, ``awseg::bn_train_backward``) on the CPU.

* The op's CPU forward is bit-equal to the composition the models ran
  before it (BN's old train branch, then ``+ residual``, then ``F.relu``),
  in f32, bf16 and f64, in both dense layouts and at H·W = 1 (ASPP's
  pooling branch), with and without the residual and the ReLU; so are the
  running statistics it leaves.
* Its registered backward (the gradient's formula) equals autograd
  through that composition: to 1e-10 in f64 and at f32's round-off in
  f32, for x, the scale, the bias and the residual, including a channel
  whose fast variance rounds below zero and is clamped.
* BN's gradients against JAX: x, scale, bias and residual gradients of
  ``BatchNorm`` in train mode with the residual and the ReLU against
  ``jax.grad`` of Flax ``nn.BatchNorm(use_running_average=False)`` plus
  residual and ReLU, in f32.
* ``opcheck`` on both ops (schema, fake, autograd registration, traced
  dispatch); each has a CPU and a CUDA kernel and nothing else; the
  launches refuse what the kernels do not take before they build
  anything, and take the schemas' defaults.
* A train-mode forward of the ensemble makes 65 ``bn_train`` calls (64 in
  DeepLabV3+, 1 in the SegFormer depth head after K9), each handing the
  kernel operands it takes; an eval forward makes none.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.models import heads
from awsegbench_torch.models.factory import create_model
from awsegbench_torch.models.heads import BatchNorm
from awsegbench_torch.ops import bn_train as bnt

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LAYOUTS = ['nchw', 'nhwc']
EPILOGUES = [(False, False), (False, True), (True, False), (True, True)]
# constants whose fast variance E[x²] − E[x]² may round below zero: one is
# chosen where it does (``_with_clamped_channel``)
CLAMP_CANDIDATES = tuple(0.1 + 0.0137 * k for k in range(400))


def _rand(*shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _in_layout(x, lay):
    fmt = (torch.channels_last if lay == 'nhwc'
           else torch.contiguous_format)
    return x.contiguous(memory_format=fmt)


def old_train_bn(bn, x, residual=None, relu=False):
    """``BatchNorm.forward``'s train branch before the op, with the residual
    add and the ReLU that followed it (one process: no mesh)."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    dims = (0,) + tuple(range(2, x.ndim))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dims)
    sq = (xf * xf).mean(dims)
    var = torch.clamp(sq - mean * mean, min=0.0)
    bn.set_stats(mean, var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    y = y.to(torch.result_type(x, bn.weight))
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def _pair(c, dtype, seed):
    """Two BNs of ``c`` channels with the same random scale, bias and
    running statistics."""
    g = torch.Generator().manual_seed(seed)
    bns = []
    for _ in range(2):
        bn = BatchNorm(c)
        with torch.no_grad():
            g.manual_seed(seed)
            bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
            bn.bias.copy_(torch.randn(c, generator=g))
            bn.running_mean.copy_(torch.randn(c, generator=g))
            bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
        bns.append(bn.to(dtype).train())
    return bns


def _operands(shape, dtype, lay, residual, seed=0):
    x = _in_layout(_rand(*shape, seed=seed) * 2 + 0.5, lay).to(dtype)
    res = (_in_layout(_rand(*shape, seed=seed + 1), lay).to(dtype)
           if residual else None)
    return x, res


SHAPES = [(2, 16, 5, 7), (3, 24, 1, 1)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize('lay', LAYOUTS)
@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('with_residual,relu', EPILOGUES)
def test_forward_equals_the_old_composition(dtype, lay, shape, with_residual,
                                            relu):
    bn, ref = _pair(shape[1], dtype, 3)
    x, res = _operands(shape, dtype, lay, with_residual)
    got = bn(x, res, relu)
    want = old_train_bn(ref, x, res, relu)
    assert torch.equal(got, want)
    assert got.dtype == want.dtype and got.stride() == x.stride()
    assert torch.equal(bn.running_mean, ref.running_mean)
    assert torch.equal(bn.running_var, ref.running_var)


def _with_clamped_channel(x, weight, bias, ch=2):
    """x with channel ``ch`` held at a constant whose fast variance, as the
    op sums it in x's layout, rounds below zero: the clamp takes it to 0
    (its KEEP row reads 0)."""
    for v in CLAMP_CANDIDATES:
        x = x.clone()
        x[:, ch] = v
        _, stats = bnt.bn_train(x, weight, bias, 1e-5)
        if stats[bnt.KEEP][ch] == 0:
            assert stats[bnt.KEEP].sum() == x.shape[1] - 1
            return x
    raise AssertionError('no candidate rounds below zero')


def _grads(module, step, x, res, dy):
    """The gradients of x, the module's scale and bias and the residual."""
    x = x.detach().clone().requires_grad_()
    res = None if res is None else res.detach().clone().requires_grad_()
    leaves = [x, module.weight, module.bias] + ([] if res is None else [res])
    return torch.autograd.grad(step(module, x, res), leaves, dy)


@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-10),
                                       (torch.float32, 2e-5)])
@pytest.mark.parametrize('lay', LAYOUTS)
@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('with_residual,relu', EPILOGUES)
def test_backward_equals_autograd_through_the_composition(
        dtype, tol, lay, shape, with_residual, relu):
    """x, scale, bias and the residual's gradients, one channel of x held
    constant at a value whose fast variance is clamped at 0 (its KEEP row
    reads 0), each within ``tol`` of the largest gradient of its kind."""
    c = shape[1]
    x, res = _operands(shape, dtype, lay, with_residual)
    bn, ref = _pair(c, dtype, 5)
    x = _with_clamped_channel(x, bn.weight.detach(), bn.bias.detach())
    dy = _in_layout(_rand(*shape, seed=7), lay).to(dtype)
    got = _grads(bn, lambda m, xx, r: m(xx, r, relu), x, res, dy)
    want = _grads(ref, lambda m, xx, r: old_train_bn(m, xx, r, relu), x, res,
                  dy)
    for name, a, b in zip(('x', 'scale', 'bias', 'residual'), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * scale, name


def _flax_bn_grads(x, params, stats, res, dy):
    """jax.grad of ⟨relu(nn.BatchNorm(train)(x) + res), dy⟩ for x, scale,
    bias and res (NHWC)."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)

    def loss(x, params, res):
        y, _ = bn.apply({'params': params, 'batch_stats': stats}, x,
                        mutable=['batch_stats'])
        return jnp.sum(jax.nn.relu(y + res) * dy)
    return jax.grad(loss, argnums=(0, 1, 2))(x, params, res)


def test_gradients_match_flax():
    rng = np.random.default_rng(11)
    c = 6
    x = (rng.standard_normal((3, 5, 7, c)) * 2 + 1).astype(np.float32)
    res = rng.standard_normal(x.shape).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    params = {'scale': rng.uniform(0.5, 1.5, c).astype(np.float32),
              'bias': rng.standard_normal(c).astype(np.float32)}
    stats = {'mean': np.zeros(c, np.float32), 'var': np.ones(c, np.float32)}
    gx, gp, gr = _flax_bn_grads(x, params, stats, res, dy)

    bn = BatchNorm(c)
    bn.load_state_dict(flax_to_torch({'params': params,
                                      'batch_stats': stats}))
    bn.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    rt = torch.from_numpy(res).permute(0, 3, 1, 2).requires_grad_()
    y = bn(xt, rt, relu=True)
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    for got, want in ((xt.grad.permute(0, 2, 3, 1), gx),
                      (bn.weight.grad, gp['scale']),
                      (bn.bias.grad, gp['bias']),
                      (rt.grad.permute(0, 2, 3, 1), gr)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('lay', LAYOUTS)
@pytest.mark.parametrize('with_residual,relu', [(False, True), (True, True),
                                                (True, False)])
def test_opcheck(dtype, lay, with_residual, relu):
    x, res = _operands((2, 16, 3, 5), dtype, lay, with_residual)
    w = (_rand(16, seed=3).abs() + 0.5).to(dtype)
    b = _rand(16, seed=4).to(dtype)
    torch.library.opcheck(torch.ops.awseg.bn_train.default,
                          (x.requires_grad_(), w.requires_grad_(),
                           b.requires_grad_(), 1e-5, res, relu))
    y, stats = bnt.bn_train(x.detach(), w.detach(), b.detach(), 1e-5,
                            res, relu)
    dy = _in_layout(_rand(2, 16, 3, 5, seed=8), lay).to(dtype)
    torch.library.opcheck(torch.ops.awseg.bn_train_backward.default,
                          (dy, x.detach(), y if relu else None, stats,
                           w.detach(), relu and with_residual))


@pytest.mark.parametrize('name', ['awseg::bn_train',
                                  'awseg::bn_train_backward'])
def test_ops_have_cpu_and_cuda_kernels_only(name):
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(name, 'CPU') and has(name, 'CUDA')
    for key in ('CompositeExplicitAutograd', 'CompositeImplicitAutograd',
                'XPU', 'MPS', 'PrivateUse1'):
        assert not has(name, key), key


def _bad_operands():
    x = _rand(2, 8, 4, 6, seed=0)
    w, b = torch.ones(8), torch.zeros(8)
    cl = x.contiguous(memory_format=torch.channels_last)
    return {
        'x transposed': ((x.transpose(2, 3), w, b, None), ValueError),
        'x a slice': ((x[:, :, :, 1:5], w, b, None), ValueError),
        'x 1-D': ((x.flatten(), w, b, None), ValueError),
        'x empty': ((x[:0], w, b, None), ValueError),
        'residual in the other layout': ((x, w, b, cl), ValueError),
        'residual of another shape': ((x, w, b, x[:1]), ValueError),
        'bf16 weight for f32 x': ((x, w.bfloat16(), b, None), TypeError),
        'bias of 7 channels': ((x, w, b[:7], None), ValueError),
        'f16 throughout': ((x.half(), w.half(), b.half(), None), TypeError),
    }


@pytest.mark.parametrize('case', sorted(_bad_operands()))
def test_the_launch_refuses_what_the_kernel_does_not_take(case):
    (x, w, b, res), err = _bad_operands()[case]
    with pytest.raises(err):
        bnt._launch_forward(x, w, b, 1e-5, res, True)


def test_the_cuda_kernels_take_the_ops_defaults():
    """The dispatcher drops arguments left at the schema's defaults, so the
    CUDA kernel must default them as the CPU kernel does."""
    import inspect
    for plain, launch in ((bnt.bn_train_plain, bnt._launch_forward),
                          (bnt.bn_train_backward_plain,
                           bnt._launch_backward)):
        want = inspect.signature(plain).parameters
        got = inspect.signature(launch).parameters
        assert list(got) == list(want)
        assert [p.default for p in got.values()] == [
            p.default for p in want.values()]


@pytest.fixture
def recorded(monkeypatch):
    """Every ``bn_train`` call the models make, checked as the kernel's
    launch checks its operands, and its layout."""
    calls = []

    def checked(x, weight, bias, eps, residual=None, relu=False):
        calls.append(bnt.check(x, weight, bias, residual))
        return bnt.bn_train(x, weight, bias, eps, residual, relu)

    monkeypatch.setattr(heads, 'bn_train', checked)
    return calls


def test_train_forward_calls_hand_the_kernel_what_it_takes(recorded):
    model = create_model({'type': 'ensemble', 'num_classes': 5},
                         device='cpu', seed=0, dtype=torch.bfloat16).train()
    seed = torch.tensor(3, dtype=torch.int32)
    model(_rand(2, 64, 128, 3, seed=0, dtype=torch.bfloat16), seed=seed,
          generator=torch.Generator().manual_seed(0),
          segformer_depth_seed=seed + 1, deeplab_depth_seed=seed + 2)
    assert len(recorded) == 65
    # the ResNet's activations are channels-last from the stem on; ASPP's
    # projection after its concatenation is channel-major
    assert recorded[0] == 'nhwc' and set(recorded) == {'nhwc', 'nchw'}


def test_eval_forward_makes_no_call(recorded):
    model = create_model({'type': 'deeplabv3plus', 'num_classes': 5},
                         device='cpu', seed=0).eval()
    with torch.inference_mode():
        model(_rand(1, 32, 64, 3, seed=0))
    assert recorded == []
