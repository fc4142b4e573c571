"""Eval-mode BN with its residual add and ReLU as one op (``ops/bn_act.py``,
K12's plain version and the custom op ``awseg::bn_act``) on the CPU.

* The op's CPU kernel is bit-equal to the composition the models ran
  before it (BN's eval branch, then ``+ residual``, then ``F.relu``) in
  f32 and bf16, in both dense layouts, with and without the residual and
  the ReLU.
* The kernel's launch refuses what it does not take before it builds
  anything: another layout of x or of the residual, a per-channel tensor
  of another dtype or size, a dtype other than bf16 and f32.
* The fake implementation traces under ``torch.export`` with a symbolic
  batch, and the exported program runs another batch as the eager op.
* Each module that calls it (``ConvBNReLU``, ``Bottleneck`` with and
  without downsample, ``SeparableConvBNReLU``, ``DepthEstimationHead``
  with and without its fused upsample) gives in eval mode exactly the old
  composition's output, and in train mode exactly the old outputs, running
  statistics and gradients: the train branch is untouched.
* In an eval forward every BN call hands the kernel operands it takes (one
  dense layout, one dtype), 53 calls in Mask2Former-R50 and 66 in the
  ensemble (64 in DeepLabV3+, 2 in the SegFormer depth head); a train-mode
  forward makes none.
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from awsegbench_torch.models import heads
from awsegbench_torch.models.deeplab import Bottleneck, SeparableConvBNReLU
from awsegbench_torch.models.factory import create_model
from awsegbench_torch.models.heads import (ConvBNReLU, DepthEstimationHead,
                                           hwio, nchw_to_nhwc, nhwc_to_nchw)
from awsegbench_torch.ops import bn_act as bna
from awsegbench_torch.ops.upconv import upsample_conv3x3

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPES = [torch.float32, torch.bfloat16]
LAYOUTS = ['nchw', 'nhwc']


def _rand(*shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _in_layout(x, lay):
    fmt = (torch.channels_last if lay == 'nhwc'
           else torch.contiguous_format)
    return x.contiguous(memory_format=fmt)


def _channels(c, dtype, seed=1):
    """mean, var (positive), weight, bias of c channels."""
    return (_rand(c, seed=seed, dtype=dtype),
            (_rand(c, seed=seed + 1).abs() + 0.2).to(dtype),
            _rand(c, seed=seed + 2, dtype=dtype),
            _rand(c, seed=seed + 3, dtype=dtype))


def old_bn_eval(bn, x):
    """``BatchNorm.forward``'s eval branch before the op."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return ((x - bn.running_mean.view(shape)) * mul.view(shape)
            + bn.bias.view(shape))


def _randomize_stats(module, seed):
    """Every BN's running statistics, scale and bias drawn at random, so
    an eval forward reads each of them."""
    for i, bn in enumerate(m for m in module.modules()
                           if isinstance(m, heads.BatchNorm)):
        c = bn.weight.numel()
        mean, var, weight, bias = _channels(c, torch.float32, seed + 4 * i)
        with torch.no_grad():
            bn.running_mean.copy_(mean * 0.1)
            bn.running_var.copy_(var)
            bn.weight.copy_(weight)
            bn.bias.copy_(bias * 0.1)
    return module


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('lay', LAYOUTS)
@pytest.mark.parametrize('with_residual,relu', [(False, False),
                                                (False, True),
                                                (True, True)])
def test_op_equals_the_old_composition(dtype, lay, with_residual, relu):
    x = _in_layout(_rand(2, 20, 5, 7, seed=0, dtype=dtype), lay)
    mean, var, weight, bias = _channels(20, dtype)
    res = (_in_layout(_rand(2, 20, 5, 7, seed=9, dtype=dtype), lay)
           if with_residual else None)
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + 1e-5) * weight
    want = (x - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    if res is not None:
        want = want + res
    if relu:
        want = F.relu(want)
    got = bna.bn_act(x, mean, var, weight, bias, 1e-5, res, relu)
    assert torch.equal(got, want)
    assert got.dtype == dtype and got.stride() == x.stride()
    assert bna.layout(got) == lay
    torch.library.opcheck(torch.ops.awseg.bn_act.default,
                          (x, mean, var, weight, bias, 1e-5, res, relu))


def _bad_operands():
    x = _rand(2, 8, 4, 6, seed=0)
    ch = _channels(8, torch.float32)
    cl = x.contiguous(memory_format=torch.channels_last)
    return {
        'x transposed': ((x.transpose(2, 3),) + ch + (None,), ValueError),
        'x a slice': ((x[:, :, :, 1:5],) + ch + (None,), ValueError),
        'x 1-D': ((x.flatten(),) + ch + (None,), ValueError),
        'residual in the other layout': ((x,) + ch + (cl,), ValueError),
        'residual of another shape': ((x,) + ch + (x[:1],), ValueError),
        'residual of another dtype': ((x,) + ch + (x.double(),),
                                      ValueError),
        'bf16 mean for f32 x': ((x, ch[0].bfloat16()) + ch[1:] + (None,),
                                TypeError),
        'weight of 7 channels': ((x, ch[0], ch[1], ch[2][:7], ch[3], None),
                                 ValueError),
        'f16 throughout': (tuple(t.half() for t in (x,) + ch) + (None,),
                           TypeError),
    }


@pytest.mark.parametrize('case', sorted(_bad_operands()))
def test_the_launch_refuses_what_the_kernel_does_not_take(case):
    (x, mean, var, weight, bias, res), err = _bad_operands()[case]
    with pytest.raises(err):
        bna._launch(x, mean, var, weight, bias, 1e-5, res, True)


class _Block(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        for name, t in zip(('mean', 'var', 'weight', 'bias'),
                           _channels(c, torch.float32)):
            self.register_buffer(name, t)

    def forward(self, x, res):
        x = nhwc_to_nchw(x)
        return nchw_to_nhwc(bna.bn_act(x, self.mean, self.var, self.weight,
                                       self.bias, 1e-5, nhwc_to_nchw(res),
                                       True))


def test_the_fake_traces_with_a_symbolic_batch():
    block = _Block(16)
    x, res = _rand(2, 5, 7, 16, seed=0), _rand(2, 5, 7, 16, seed=1)
    batch = torch.export.Dim('b', min=1)
    ep = torch.export.export(block, (x, res),
                             dynamic_shapes={'x': {0: batch},
                                             'res': {0: batch}},
                             strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == 'call_function']
    assert targets.count('awseg.bn_act.default') == 1
    assert len(ep.range_constraints) == 1
    x3, res3 = _rand(3, 5, 7, 16, seed=2), _rand(3, 5, 7, 16, seed=3)
    assert torch.equal(ep.module()(x3, res3), block(x3, res3))


def _old_conv_bn_relu(m, x):
    x = old_bn_eval(m.BatchNorm_0, m.Conv_0(x))
    return F.relu(x) if m.use_relu else x


def _old_bottleneck(m, x):
    y = old_bn_eval(m.BatchNorm_0, m.Conv_0(_old_conv_bn_relu(
        m.ConvBNReLU_1, _old_conv_bn_relu(m.ConvBNReLU_0, x))))
    residual = (old_bn_eval(m.BatchNorm_1, m.Conv_1(x)) if m.downsample
                else x)
    return F.relu(y + residual)


def _old_separable(m, x):
    return F.relu(old_bn_eval(m.BatchNorm_0, m.Conv_1(m.Conv_0(x))))


def _old_depth_head(m, features, upsample_scale=None):
    if upsample_scale is not None:
        x = nhwc_to_nchw(upsample_conv3x3(features, hwio(m.Conv_0),
                                          m.Conv_0.bias,
                                          scale=upsample_scale))
    else:
        x = m.Conv_0(nhwc_to_nchw(features))
    x = m.Conv_1(F.relu(old_bn_eval(m.BatchNorm_0, x)))
    x = F.relu(old_bn_eval(m.BatchNorm_1, x))
    return nchw_to_nhwc(torch.sigmoid(m.Conv_2(x)))


def _nchw_input(c, seed, dtype, h=8, w=12):
    """An NCHW view of an NHWC tensor, as the models hand their convs."""
    return nhwc_to_nchw(_rand(2, h, w, c, seed=seed, dtype=dtype))


MODULES = {
    'ConvBNReLU': (lambda: ConvBNReLU(16, 24, 3),
                   lambda d: (_nchw_input(16, 5, d),), _old_conv_bn_relu),
    'ConvBNReLU no relu': (lambda: ConvBNReLU(16, 24, 1, use_relu=False),
                           lambda d: (_nchw_input(16, 5, d),),
                           _old_conv_bn_relu),
    'Bottleneck': (lambda: Bottleneck(64, 16),
                   lambda d: (_nchw_input(64, 6, d),), _old_bottleneck),
    'Bottleneck downsample': (lambda: Bottleneck(32, 16, stride=2,
                                                 downsample=True),
                              lambda d: (_nchw_input(32, 7, d),),
                              _old_bottleneck),
    'SeparableConvBNReLU': (lambda: SeparableConvBNReLU(16, 24, 2),
                            lambda d: (_nchw_input(16, 8, d),),
                            _old_separable),
    'DepthEstimationHead': (lambda: DepthEstimationHead(16, 32),
                            lambda d: (_rand(2, 8, 12, 16, seed=9, dtype=d),),
                            _old_depth_head),
    'DepthEstimationHead upsampled': (
        lambda: DepthEstimationHead(16, 32),
        lambda d: (_rand(2, 4, 6, 16, seed=10, dtype=d), 4),
        _old_depth_head),
}


def _module(name, dtype, seed=0):
    make, inputs, old = MODULES[name]
    torch.manual_seed(seed)
    m = _randomize_stats(make(), 100 + seed).to(dtype)
    return m, inputs(dtype), old


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', sorted(MODULES))
def test_eval_forward_equals_the_old_composition(name, dtype):
    m, args, old = _module(name, dtype)
    m.eval()
    with torch.no_grad():
        assert torch.equal(m(*args), old(m, *args))


def _old_train_forward(name, m, args):
    """The pre-op train forwards: BN's train branch (untouched) with the
    ReLU and residual add after it, in the old order."""
    if name.startswith('ConvBNReLU'):
        x = m.BatchNorm_0(m.Conv_0(args[0]))
        return F.relu(x) if m.use_relu else x
    if name.startswith('Bottleneck'):
        def cbr(c, x):
            return F.relu(c.BatchNorm_0(c.Conv_0(x)))
        x = args[0]
        y = m.BatchNorm_0(m.Conv_0(cbr(m.ConvBNReLU_1,
                                       cbr(m.ConvBNReLU_0, x))))
        residual = m.BatchNorm_1(m.Conv_1(x)) if m.downsample else x
        return F.relu(y + residual)
    if name == 'SeparableConvBNReLU':
        return F.relu(m.BatchNorm_0(m.Conv_1(m.Conv_0(args[0]))))
    features, seed = args[0], torch.tensor(7, dtype=torch.int32)
    x = F.relu(m.BatchNorm_0(m.Conv_0(nhwc_to_nchw(features))))
    x = m.Conv_1(heads.hash_dropout(x, seed, m.dropout))
    x = F.relu(m.BatchNorm_1(x))
    return nchw_to_nhwc(torch.sigmoid(m.Conv_2(x)))


@pytest.mark.parametrize('name', ['ConvBNReLU', 'Bottleneck',
                                  'Bottleneck downsample',
                                  'SeparableConvBNReLU',
                                  'DepthEstimationHead'])
def test_train_forward_is_untouched(name):
    m, args, _ = _module(name, torch.float32)
    ref = copy.deepcopy(m)
    m.train()
    ref.train()
    kwargs = ({'seed': torch.tensor(7, dtype=torch.int32)}
              if name == 'DepthEstimationHead' else {})
    got = m(*args, **kwargs)
    want = _old_train_forward(name, ref, args)
    assert torch.equal(got, want)
    for b, b0 in zip(m.buffers(), ref.buffers()):
        assert torch.equal(b, b0)
    got.square().sum().backward()
    want.square().sum().backward()
    for (n, p), p0 in zip(m.named_parameters(), ref.parameters()):
        assert torch.equal(p.grad, p0.grad), n


@pytest.fixture
def recorded(monkeypatch):
    """Every ``bn_act`` call the models make, checked as the kernel's
    launch checks its operands, and its layout."""
    calls = []

    def checked(x, mean, var, weight, bias, eps, residual=None, relu=False):
        calls.append(bna.check(x, mean, var, weight, bias, residual))
        return bna.bn_act(x, mean, var, weight, bias, eps, residual, relu)

    monkeypatch.setattr(heads, 'bn_act', checked)
    return calls


@pytest.mark.parametrize('kind,hw,calls', [('mask2former', (64, 128), 53),
                                           ('ensemble', (32, 64), 66),
                                           ('deeplabv3plus', (32, 64), 64)])
def test_eval_forward_calls_hand_the_kernel_what_it_takes(recorded, kind,
                                                          hw, calls):
    model = create_model({'type': kind, 'num_classes': 5}, device='cpu',
                         seed=0, dtype=torch.bfloat16)
    with torch.inference_mode():
        model(_rand(1, *hw, 3, seed=0, dtype=torch.bfloat16))
    assert len(recorded) == calls
    assert set(recorded) <= {'nhwc', 'nchw'}
    # the ResNet's activations are channels-last from the stem on
    assert recorded[0] == 'nhwc'


def test_train_forward_makes_no_call(recorded):
    model = create_model({'type': 'deeplabv3plus', 'num_classes': 5},
                         device='cpu', seed=0).train()
    model(_rand(2, 32, 64, 3, seed=0),
          generator=torch.Generator().manual_seed(0),
          depth_seed=torch.tensor(3, dtype=torch.int32))
    assert recorded == []


def test_the_cuda_kernel_takes_the_ops_defaults():
    """The dispatcher drops arguments left at the schema's defaults, so the
    CUDA kernel must default them as the CPU kernel does."""
    import inspect
    want = inspect.signature(bna.bn_act_plain).parameters
    got = inspect.signature(bna._launch).parameters
    assert list(got) == list(want)
    assert [p.default for p in got.values()] == [p.default
                                                 for p in want.values()]
