"""K13 and K14 (``csrc/bn_train.cu``) against their plain versions on the
card, and how often the train step launches them.

The plain versions (``bn_train_plain``, ``bn_train_backward_plain``) run
here in f64 on the kernels' own operands; the kernels sum in f32 in
another order. Forward: the statistics within 1e-5 of E[x²] (mean, var);
y within 1e-5 of the terms' sizes (|x − mean| + √E[x²])·|r·weight| +
|bias| + |residual| in f32 (√E[x²]: the scale of the mean's rounding
error), and in bf16 equal to the f64 value rounded once to bf16 or one
bf16 step beside it (plus that 1e-5). Backward, with the kernel's own y
deciding the ReLU mask: dx within 1e-5 of |weight·r|·(|g'| + Σ|g'|/n +
(|x̂| + r·√E[x²])·Σ|g'x̂|/n) (sums of absolute values: the scale a
rounding error of the signed sums takes), in bf16 again one step
beside the f64 value rounded; dweight and dbias within 1e-5 of Σ|g'x̂| and
Σ|g'| (one bf16 step more in bf16); dresidual = the masked dy exactly.

Cases: the train cell's shapes (the stem, a layer-1 block's end with its
residual, layer 4 with its residual, the SegFormer depth head's BN at full
resolution, ASPP's pooled branch) in bf16 and f32, both layouts, a ragged
C, a C above the vector path's 2048, an unaligned tensor. Two runs give
bit-identical results; each call launches K13 once and its gradient K14
once; a train step of the ensemble launches each 65 times (one per BN),
an eval forward neither.

Needs a card: marked ``card`` and skipped without one. Run on the card with
``python -m pytest --noconftest -m card tests/test_torch_bn_train_card.py``.
This file imports no JAX.
"""

import pytest
import torch

from awsegbench_torch import _build
from awsegbench_torch.ops import bn_train as bnt

RTOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


def operands(shape, dtype, lay, dev, residual, seed=0, offset=0):
    """x (off-centre, so that the fast variance cancels a little), the
    residual and dy in layout ``lay``, starting ``offset`` elements into
    their storage; weight and bias."""
    g = torch.Generator(dev).manual_seed(seed)
    c = shape[1]

    def tensor(scale=1.0, shift=0.0):
        t = (torch.randn(shape, generator=g, device=dev) * scale
             + shift).to(dtype)
        if lay == 'nhwc':
            t = t.contiguous(memory_format=torch.channels_last)
        if offset:
            buf = torch.empty(t.numel() + offset, dtype=dtype, device=dev)
            t = buf[offset:].as_strided(t.shape, t.stride()).copy_(t)
        return t

    x = tensor(1.5, 0.3)
    res = tensor() if residual else None
    dy = tensor()
    weight = (torch.randn(c, generator=g, device=dev) * 0.5 + 1).to(dtype)
    bias = (torch.randn(c, generator=g, device=dev) * 0.5).to(dtype)
    return x, weight, bias, res, dy


def bf16_step(x):
    """One bf16 step (unit in the last place) of each value; 0 at 0."""
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, 0.0,
                       torch.ldexp(torch.ones_like(x.float()), e - 8))


def within(got, want, size, what):
    """got against the f64 ``want``: RTOL of ``size`` in f32; in bf16 one
    step beside ``want`` rounded once, plus that."""
    want_r = want.to(got.dtype)
    room = RTOL * size
    if got.dtype == torch.bfloat16:
        room = room + bf16_step(want_r)
    err = (got.double() - (want if got.dtype == torch.float32
                           else want_r.double())).abs()
    assert bool((err <= room).all()), \
        f'{what}: off by {float((err - room).max())} beyond its room'


def hold(shape, dtype, lay, dev, residual, relu, offset=0):
    """K13 and K14 at one case against the plain versions in f64 (module
    docstring); returns the kernels' outputs."""
    x, w, b, res, dy = operands(shape, dtype, lay, dev, residual,
                                offset=offset)
    y, stats = bnt.bn_train(x, w, b, 1e-5, res, relu)
    assert y.dtype == dtype and y.stride() == x.stride()
    d = [None if t is None else t.double() for t in (x, w, b, res, dy)]
    y64, st64 = bnt.bn_train_plain(d[0], d[1], d[2], 1e-5, d[3], relu)
    dims, shape1 = bnt._dims_shape(x)
    ex2 = (d[0] * d[0]).mean(dims)
    for row, name in ((bnt.MEAN, 'mean'), (bnt.VAR, 'var')):
        scale = ex2.sqrt() if row == bnt.MEAN else ex2
        err = (stats[row].double() - st64[row]).abs()
        assert bool((err <= RTOL * scale).all()), name
    mul = (st64[bnt.RSTD] * d[1]).abs().view(shape1)
    rms = ex2.sqrt().view(shape1)        # the scale of the mean's error
    size = (((d[0] - st64[bnt.MEAN].view(shape1)).abs() + rms) * mul
            + d[2].abs().view(shape1)
            + (0.0 if res is None else d[3].abs()))
    within(y, y64, size, 'y')

    want_dres = relu and residual
    dx, dres, dwb = torch.ops.awseg.bn_train_backward(
        dy, x, y if relu else None, stats, w, want_dres)
    assert dx.dtype == dtype and dx.stride() == x.stride()
    yy = y.double() if relu else None
    gx, gres, gwb = bnt.bn_train_backward_plain(d[4], d[0], yy, st64, d[1],
                                                want_dres)
    g = d[4] if yy is None else torch.where(yy <= 0, 0.0, d[4])
    xhat = ((d[0] - st64[bnt.MEAN].view(shape1))
            * st64[bnt.RSTD].view(shape1))
    n = x.numel() // x.shape[1]
    abs_g, abs_gx = g.abs().sum(dims), (g * xhat).abs().sum(dims)
    size = mul * (g.abs() + (abs_g / n).view(shape1)
                  + (xhat.abs() + rms * st64[bnt.RSTD].view(shape1))
                  * (abs_gx / n).view(shape1))
    within(dx, gx, size, 'dx')
    within(dwb[0], gwb[0], abs_gx, 'dweight')
    within(dwb[1], gwb[1], abs_g, 'dbias')
    if want_dres:
        assert torch.equal(dres, g.to(dtype)), 'dresidual'
    return y, stats, dx, dwb


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('lay', ['nhwc', 'nchw'])
@pytest.mark.parametrize('shape,residual,relu,offset', [
    ((2, 20, 7, 9), True, True, 0),       # ragged C: the scalar kernels
    ((2, 64, 5, 8), False, True, 0),      # 8 groups
    ((3, 48, 4, 4), True, False, 0),      # 6 groups: 252-thread blocks
    ((1, 2048, 3, 5), True, True, 0),     # 256 groups
    ((2, 4096, 2, 2), False, False, 0),   # above the vector path's C
    ((2, 64, 4, 8), True, True, 3),       # unaligned: the scalar kernels
    ((4, 256, 32, 64), False, True, 0),   # ASPP's projection's shape
])
def test_k13_k14_match_the_plain_versions(card, dtype, lay, shape, residual,
                                          relu, offset):
    hold(shape, dtype, lay, card, residual, relu, offset)


# The train cell's shapes (batch 8 at 512×1024), channels-last as the
# models run them: the ResNet-50's stem, a layer-1 block's last BN with its
# residual, layer 4 with its residual, the SegFormer depth head's BN after
# K9 at full resolution, ASPP's pooled branch.
CELLS = {'stem': ((8, 64, 256, 512), False, True),
         'layer1 block': ((8, 256, 128, 256), True, True),
         'layer4 block': ((8, 2048, 32, 64), True, True),
         'segformer depth bn': ((8, 64, 512, 1024), False, True),
         'aspp pooling': ((8, 256, 1, 1), False, True)}


@pytest.mark.card
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cell', sorted(CELLS))
def test_k13_k14_at_the_cells_shapes(card, cell, dtype):
    shape, residual, relu = CELLS[cell]
    hold(shape, dtype, 'nhwc', card, residual, relu)
    torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize('cell', ['stem', 'layer4 block'])
def test_two_runs_are_bit_identical(card, cell):
    shape, residual, relu = CELLS[cell]
    x, w, b, res, dy = operands(shape, torch.bfloat16, 'nhwc', card,
                                residual)
    runs = []
    for _ in range(2):
        y, stats = bnt.bn_train(x, w, b, 1e-5, res, relu)
        runs.append((y, stats, *torch.ops.awseg.bn_train_backward(
            dy, x, y, stats, w, relu and residual)))
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


def _counts(run):
    torch.cuda.synchronize()
    _build.launches.clear()
    run()
    torch.cuda.synchronize()
    return _build.launches['bn_train'], _build.launches['bn_train_backward']


@pytest.mark.card
def test_one_launch_of_each_per_call(card):
    x, w, b, res, dy = operands((4, 64, 16, 32), torch.bfloat16, 'nhwc',
                                card, True)
    leaves = [t.requires_grad_() for t in (x, w, b, res)]

    def run():
        y, _ = bnt.bn_train(*leaves[:3], 1e-5, leaves[3], True)
        torch.autograd.grad(y, leaves, dy)

    run()                                         # the build, once
    assert _counts(run) == (1, 1)


@pytest.mark.card
def test_raises_on_what_it_does_not_take(card):
    x, w, b, _, _ = operands((2, 16, 4, 6), torch.float32, 'nchw', card,
                             False)
    with pytest.raises(ValueError):
        bnt.bn_train(x.transpose(2, 3), w, b, 1e-5)
    with pytest.raises(TypeError):
        bnt.bn_train(x.half(), w.half(), b.half(), 1e-5)
    with pytest.raises(TypeError):
        bnt.bn_train(x, w.bfloat16(), b, 1e-5)


@pytest.mark.card
def test_a_train_step_launches_each_once_per_bn(card):
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
    step(images, labels, wids, generator=g)      # the builds, once
    assert _counts(lambda: step(images, labels, wids, generator=g)) \
        == (65, 65)
    x = torch.randn(1, 128, 256, 3, device=card).bfloat16()
    model = model.eval().to(torch.bfloat16)
    with torch.inference_mode():
        assert _counts(lambda: model(x)) == (0, 0)
