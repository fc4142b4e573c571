"""K15 (``csrc/window_attention.cu``) against its plain version on the card.

In f32 the kernel (CUDA cores, ``expf``) and the plain version (the
published composition: matmul, bias and mask added, softmax, matmul) sum
in other orders: a few ulps of outputs of size about 1. The −100 of the
shift mask is an exact zero weight in the kernel: exp(−100) is below
f32's normal range, so the two agree there too. In bf16 the kernel rounds
the probabilities to bf16 for the product (2^-9 of each term) and both
round the output once: outputs about 1 apart by a bf16 step or two. At
the cell's shapes (Mask2Former-Swin-L at 1024×2048, batch 4: stage 1's
264×516 padded map with 6 heads, stage 3's 72×132 with 24) the kernel
agrees as closely and takes less device time than the published
composition; a Swin-L forward launches it once a block, 24 times.

Needs a card: marked ``card`` and skipped without one. Run on the card with
``python -m pytest --noconftest -m card
tests/test_torch_window_attention_card.py -s``. This file imports no JAX.
"""

import pytest
import torch

from awsegbench_torch import _build
from awsegbench_torch.models.swin import SwinTransformer
from awsegbench_torch.ops import window_attention as wa

# (b, hp, wp, heads, window, shift) off the cell: a window of 7 (49
# tokens: the last row tile ragged), 3 and 5 heads (blocks of 3 heads and
# of 1), one window a side, a window of 5, the cell's window of 12
RAGGED = ((2, 14, 21, 3, 7, 3), (1, 7, 7, 5, 7, 0), (2, 24, 36, 2, 12, 6),
          (1, 12, 24, 1, 12, 0), (3, 10, 15, 4, 5, 2))
# the cell's stage-1 and stage-3 launches, both shifts
STAGES = ((4, 264, 516, 6), (4, 72, 132, 24))
# f32: the two orders of a 144-term softmax-weighted sum of normal draws
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: the kernel's bf16 probabilities move the sum by up to 2^-9 of
# Σ p|v| (|v| up to about 4), and each side rounds the output once
BF16_TOL = dict(rtol=2 ** -7, atol=8e-3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


def operands(b, hp, wp, heads, window, dtype, dev, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    qkv = torch.randn(b, hp, wp, 3 * heads * 32, generator=g, device=dev)
    table = torch.randn((2 * window - 1) ** 2, heads, generator=g,
                        device=dev)
    return qkv.to(dtype), table.to(dtype)


def device_ms(fn, reps=10):
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
@pytest.mark.parametrize('b,hp,wp,heads,window,shift', RAGGED)
def test_k15_matches_the_plain_version(card, dtype, tol, b, hp, wp, heads,
                                       window, shift):
    qkv, table = operands(b, hp, wp, heads, window, dtype, card)
    before = _build.launches['window_attention']
    got = wa.window_attention(qkv, table, heads, window, shift, 32 ** -0.5)
    assert _build.launches['window_attention'] == before + 1
    assert got.dtype == dtype and got.shape == (b, hp, wp, heads * 32)
    want = wa.window_attention_plain(qkv, table, heads, window, shift,
                                     32 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.card
@pytest.mark.parametrize('dtype,tol', [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize('shift', [0, 6])
@pytest.mark.parametrize('b,hp,wp,heads', STAGES)
def test_k15_at_the_cell_shapes(card, dtype, tol, b, hp, wp, heads, shift):
    """Agreement at the cell's launches; in bf16 K15 beside the published
    composition in bf16, which it must beat."""
    qkv, table = operands(b, hp, wp, heads, 12, dtype, card)

    def k15():
        return wa.window_attention(qkv, table, heads, 12, shift, 32 ** -0.5)

    def published():
        return wa.window_attention_published(qkv, table, heads, 12, shift,
                                             32 ** -0.5)
    want = wa.window_attention_plain(qkv, table, heads, 12, shift,
                                     32 ** -0.5)
    torch.testing.assert_close(k15().float(), want.float(), **tol)
    del want
    if dtype == torch.bfloat16:
        ms, pub = device_ms(k15), device_ms(published, reps=3)
        print(f'K15 {b}x{hp}x{wp} heads {heads} shift {shift}: {ms:.4f} ms, '
              f'published {pub:.4f} ms ({torch.cuda.get_device_name(0)})')
        assert ms < pub


@pytest.mark.card
def test_a_swin_l_forward_launches_k15_once_a_block(card):
    model = SwinTransformer(192, (2, 2, 18, 2), (6, 12, 24, 48)).to(
        card, torch.bfloat16).eval()
    x = torch.randn(1, 3, 256, 512, device=card, dtype=torch.bfloat16)
    _build.launches.clear()
    _build.design_launches.clear()
    with torch.inference_mode():
        outs = model(x)
    torch.cuda.synchronize()
    assert _build.launches['window_attention'] == 24
    assert _build.design_launches['window_attention', 'mma_bf16'] == 24
    assert [tuple(o.shape) for o in outs] == [
        (1, 192, 64, 128), (1, 384, 32, 64), (1, 768, 16, 32),
        (1, 1536, 8, 16)]
    assert all(bool(o.isfinite().all()) for o in outs)
