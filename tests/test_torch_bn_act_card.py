"""K12 (``csrc/bn_act.cu``) against its plain version on the card, and how
often the models launch it.

The kernel computes ``act((x − mean)·(rsqrt(var + eps)·weight) + bias
[+ residual])`` in f32 and rounds once. In f32 the plain version runs the
same operations, each rounded: the two agree to 1e-6 of the terms' sizes
(|x − mean|·|mul| + |bias| + |residual|, the scale a rounding error of
the sum takes). In bf16 the kernel equals the plain version's function in
f32 rounded once to bf16, or lies one bf16 step beside it (the two f32
sums differ by a few ulps; near 0, by up to their f32 gap); against the
plain version in bf16, which rounds five times, each time by up to 2^-8
of the value, it lies within 2^-5 of the terms' sizes. Cases: the
shapes Mask2Former-R50 and the SegFormer depth head run in the sweep
cells, both layouts, a ragged C, a C above the vector path's 2048, an
unaligned tensor, 1×1 maps.

Launches: one bf16 eval forward of Mask2Former-R50 launches K12 53 times
(every BN of its ResNet-50), the ensemble 66 times (64 in DeepLabV3+, 2 in
the SegFormer depth head), and a train step never.

Needs a card: marked ``card`` and skipped without one. Run on the card with
``python -m pytest --noconftest -m card tests/test_torch_bn_act_card.py``.
This file imports no JAX.
"""

import pytest
import torch

from awsegbench_torch import _build
from awsegbench_torch.ops import bn_act as bna

F32_RTOL = 1e-6
BF16_PLAIN_RTOL = 2 ** -5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


def operands(shape, dtype, lay, dev, residual, seed=0, offset=0):
    """x (and the residual) in layout ``lay``, starting ``offset`` elements
    into their storage; per-channel mean, var (positive), weight, bias."""
    g = torch.Generator(dev).manual_seed(seed)
    c = shape[1]

    def tensor():
        t = torch.randn(shape, generator=g, device=dev).to(dtype)
        if lay == 'nhwc':
            t = t.contiguous(memory_format=torch.channels_last)
        if offset:
            buf = torch.empty(t.numel() + offset, dtype=dtype, device=dev)
            t = buf[offset:].as_strided(t.shape, t.stride()).copy_(t)
        return t

    x = tensor()
    res = tensor() if residual else None
    mean = (torch.randn(c, generator=g, device=dev) * 0.5).to(dtype)
    var = (torch.rand(c, generator=g, device=dev) + 0.1).to(dtype)
    weight = torch.randn(c, generator=g, device=dev).to(dtype)
    bias = (torch.randn(c, generator=g, device=dev) * 0.5).to(dtype)
    return x, mean, var, weight, bias, res


def room(x, mean, var, weight, bias, res):
    """|x − mean|·|mul| + |bias| + |residual| in f32: the size of the terms
    whose sum each side rounds."""
    f = [None if t is None else t.float() for t in (x, mean, var, weight,
                                                     bias, res)]
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mul = torch.rsqrt(f[2] + 1e-5) * f[3]
    r = ((f[0] - f[1].view(shape)).abs() * mul.abs().view(shape)
         + f[4].abs().view(shape))
    return r if res is None else r + f[5].abs()


def bf16_step(x):
    """One bf16 step (unit in the last place) of each value; 0 at 0."""
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, 0.0,
                       torch.ldexp(torch.ones_like(x.float()), e - 8))


def hold(ops, relu):
    """K12 on ``ops`` against the plain version (module docstring)."""
    got = bna.bn_act(*ops[:5], 1e-5, ops[5], relu)
    assert got.dtype == ops[0].dtype and got.stride() == ops[0].stride()
    plain = bna.bn_act_plain(*ops[:5], 1e-5, ops[5], relu)
    size = room(*ops)
    if ops[0].dtype == torch.float32:
        err = (got - plain).abs()
        assert bool((err <= F32_RTOL * size + 1e-30).all()), \
            float((err / size).max())
        return
    f32 = bna.bn_act_plain(*(None if t is None else t.float() for t in
                             ops[:5]), 1e-5,
                           None if ops[5] is None else ops[5].float(), relu)
    once = f32.bfloat16()
    assert bool(((got.float() - once.float()).abs()
                 <= bf16_step(once) + F32_RTOL * size).all())
    err = (got.float() - plain.float()).abs()
    assert bool((err <= BF16_PLAIN_RTOL * size).all()), \
        float((err / size).max())


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('lay', ['nhwc', 'nchw'])
@pytest.mark.parametrize('shape,residual,relu,offset', [
    ((2, 20, 7, 9), True, True, 0),       # ragged C: the scalar kernel
    ((2, 64, 5, 8), False, True, 0),      # 8 groups
    ((3, 48, 4, 4), True, False, 0),      # 6 groups: 252-thread blocks
    ((1, 2048, 3, 5), True, True, 0),     # 256 groups
    ((2, 4096, 2, 2), False, False, 0),   # above the vector path's C
    ((2, 16, 1, 1), True, True, 0),       # both layouts at once
    ((2, 64, 4, 8), True, True, 3),       # unaligned: the scalar kernel
])
def test_k12_matches_the_plain_version(card, dtype, lay, shape, residual,
                                       relu, offset):
    hold(operands(shape, dtype, lay, card, residual, offset=offset), relu)


# The sweep cells' shapes (bf16, channels-last as the models run them):
# Mask2Former-R50's stem and a layer-1 block's last BN with its residual at
# 1024×2048, batch 4; the SegFormer depth head's first BN at 512×1024,
# batch 8; and the stem's shape channel-major, which no cell's BN is: the
# scalar kernel, held at size.
CELLS = {'m2f stem': ((4, 64, 512, 1024), 'nhwc', False, True),
         'm2f layer1 block': ((4, 256, 256, 512), 'nhwc', True, True),
         'segformer depth head': ((8, 256, 512, 1024), 'nhwc', False, True),
         'm2f stem nchw': ((4, 64, 512, 1024), 'nchw', False, True)}


@pytest.mark.card
@pytest.mark.parametrize('cell', sorted(CELLS))
def test_k12_at_the_cells_shapes(card, cell):
    shape, lay, residual, relu = CELLS[cell]
    hold(operands(shape, torch.bfloat16, lay, card, residual), relu)
    torch.cuda.empty_cache()


def _count(run):
    torch.cuda.synchronize()
    _build.launches.clear()
    run()
    torch.cuda.synchronize()
    return _build.launches['bn_act']


@pytest.mark.card
@pytest.mark.parametrize('kind,launches', [('mask2former', 53),
                                           ('ensemble', 66)])
def test_one_eval_forward_launches_k12_per_bn(card, kind, launches):
    from awsegbench_torch.models import create_model
    model = create_model({'type': kind, 'num_classes': 19}, device=card,
                         seed=0, dtype=torch.bfloat16)
    x = torch.randn(1, 128, 256, 3, device=card).bfloat16()
    with torch.inference_mode():
        model(x)                                  # the build, once
        assert _count(lambda: model(x)) == launches


@pytest.mark.card
def test_a_train_step_launches_no_k12(card):
    from awsegbench_torch.models import create_model
    from awsegbench_torch.train.step import TrainStep
    model = create_model({'type': 'ensemble', 'num_classes': 19},
                         device=card, seed=0)
    step = TrainStep(model, device=card)
    g = torch.Generator(device=card).manual_seed(0)
    images = torch.randint(0, 256, (2, 128, 256, 3), generator=g,
                           device=card, dtype=torch.uint8)
    labels = torch.randint(0, 19, (2, 128, 256), generator=g, device=card)
    wids = torch.arange(2, device=card) % 5
    assert _count(lambda: step(images, labels, wids, generator=g)) == 0
