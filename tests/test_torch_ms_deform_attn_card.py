"""K11 (``csrc/ms_deform_attn.cu``) against its plain version on the card.

The kernel sums a point's four bilinear taps and its weight in f32 and
rounds once, as the plain version (``F.grid_sample`` in f32) does; the
two sum in other orders, so in f32 they agree to a few ulps and in bf16
each output is the plain one or one bf16 step beside it. At Mask2Former-
R50's shape in the sweep (1024×2048, batch 4: 43,008 queries over the
1/32, 1/16 and 1/8 levels) the kernel agrees as closely and takes less
device time than the plain composition.

Needs a card: marked ``card`` and skipped without one. Run on the card with
``python -m pytest --noconftest -m card tests/test_torch_ms_deform_attn_card.py``.
This file imports no JAX.
"""

import pytest
import torch

from awsegbench_torch import _build
from awsegbench_torch.ops import ms_deform_attn as msda

# the cell's levels: res5, res4, res3 of a 1024×2048 image
CELL = (32, 64, 64, 128, 128, 256)
# An output sums 4·L·P products of values up to about 4 (normal draws)
# with weights that sum to 1; two f32 orders of that sum differ by up to a
# few 1e-6 (4 · 48 products · 2^-24 ≈ 1.1e-5 at L·P = 12). bf16 rounds
# the two sums once each: one bf16 step apart at most, or the f32 gap
# where the output is near 0.
F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


def operands(b, shapes, lq, m, d, points, dtype, dev, seed=0):
    """Values, locations and weights: the locations a query's reference
    point plus offsets of up to 5 pixels of each level, about 1 in 8 of
    them past the map's edge; some exactly on an edge."""
    g = torch.Generator(dev).manual_seed(seed)
    sizes = msda.level_sizes(shapes)
    s = sum(h * w for h, w in sizes)
    value = torch.randn(b, s, m, d, generator=g, device=dev).to(dtype)
    ref = torch.rand(b, lq, 1, 1, 1, 2, generator=g, device=dev)
    wh = torch.tensor([[w, h] for h, w in sizes], dtype=torch.float32,
                      device=dev).view(1, 1, 1, len(sizes), 1, 2)
    off = (torch.rand(b, lq, m, len(sizes), points, 2, generator=g,
                      device=dev) - 0.5) * 10.0
    loc = ref + off / wh
    loc[:, ::7, :, :, 0, 0] = 0.0                  # on the left edge
    loc[:, ::11, :, :, 1, 1] = 1.0                 # on the bottom edge
    attn = torch.softmax(torch.randn(b, lq, m, len(sizes) * points,
                                     generator=g, device=dev), -1)
    return value, loc, attn.view(b, lq, m, len(sizes), points)


def device_ms(fn, reps=20):
    """Mean milliseconds of ``fn`` by CUDA events after a warm call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.card
@pytest.mark.parametrize('dtype,tol', [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize('shapes,m,d,points', [
    ((3, 5, 7, 2), 2, 8, 3), ((1, 1, 4, 6, 2, 9), 8, 32, 4),
    ((5, 3, 8, 8, 2, 2, 1, 1), 4, 16, 2)])
def test_k11_matches_the_plain_version(card, dtype, tol, shapes, m, d,
                                       points):
    value, loc, attn = operands(2, shapes, 37, m, d, points, dtype, card)
    before = _build.launches['ms_deform_attn']
    got = msda.ms_deform_attn(value, shapes, loc, attn)
    assert _build.launches['ms_deform_attn'] == before + 1
    assert got.dtype == dtype and got.shape == (2, 37, m * d)
    want = msda.ms_deform_attn_plain(value, shapes, loc, attn)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.card
def test_k11_at_the_cell_shape(card):
    """bf16 at the sweep's shape: agreement within one bf16 step, and less
    device time than the plain composition."""
    lq = sum(h * w for h, w in msda.level_sizes(CELL))
    value, loc, attn = operands(4, CELL, lq, 8, 32, 4, torch.bfloat16, card)
    got = msda.ms_deform_attn(value, CELL, loc, attn)
    want = msda.ms_deform_attn_plain(value, CELL, loc, attn)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    k11 = device_ms(lambda: msda.ms_deform_attn(value, CELL, loc, attn))
    plain = device_ms(lambda: msda.ms_deform_attn_plain(value, CELL, loc,
                                                        attn), reps=5)
    print(f'K11 {k11:.4f} ms, plain {plain:.4f} ms a launch '
          f'({torch.cuda.get_device_name(0)})')
    assert k11 < plain
