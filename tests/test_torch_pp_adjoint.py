"""The neighbourhood stack's adjoint, ``neighbor_pp_adjoint`` (the train
backwards' scatter of dpp back to P), and the limits the train kernels'
wrappers state before any build.

On CPU tensors ``neighbor_pp_adjoint`` is the plain
``_neighbor_pp_adjoint`` rounded to dpp's dtype; on the card
``csrc/pp_adjoint.cu`` sums in the same order and chip_smoke.py holds it to
that bit for bit. Here: the CPU route, at grids where cells are clamped on
one or both axes (h or w of 1), and that it is the gather's transpose.
"""

import numpy as np
import pytest
import torch

from awsegbench_torch import _build
from awsegbench_torch.ops import depthkernels_train as dk
from awsegbench_torch.ops import headkernels, headkernels_train as ht

SHAPES = [(2, 3, 4, 81, 16), (1, 1, 1, 81, 8), (2, 1, 5, 81, 24),
          (2, 4, 1, 81, 8), (1, 2, 2, 81, 20)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', SHAPES)
def test_cpu_route_is_the_plain_adjoint(shape, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    dpp = torch.randn(shape, generator=g).to(dtype)
    got = ht.neighbor_pp_adjoint(dpp)
    want = ht._neighbor_pp_adjoint(dpp).to(dtype)
    assert got.dtype == dtype and got.shape == (*shape[:3], 9, shape[4])
    assert torch.equal(got, want)
    assert _build.launches['neighbor_pp_adjoint'] == 0


@pytest.mark.parametrize('shape', SHAPES)
def test_adjoint_is_the_gathers_transpose(shape):
    """<gather(x), y> = <x, adjoint(y)> in f64, clamped edges included."""
    b, h, w, _, c = shape
    g = torch.Generator().manual_seed(7)
    y = torch.randn(shape, generator=g, dtype=torch.float64)
    x = torch.randn((b, h, w, 9, c), generator=g, dtype=torch.float64)
    lhs = (headkernels._neighbor_pp(x.reshape(b, h, w, 3, 3, c)) * y).sum()
    rhs = (x * ht._neighbor_pp_adjoint(y).double()).sum()
    assert torch.allclose(lhs, rhs)


def test_pp_adjoint_wrapper_states_its_limits():
    with pytest.raises(TypeError, match='f32 or bf16'):
        ht._launch_pp_adjoint(torch.zeros(1, 2, 2, 81, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match=r'\[B, h, w, 81, C\]'):
        ht._launch_pp_adjoint(torch.zeros(1, 2, 2, 80, 8))
    with pytest.raises(ValueError, match=r'\[B, h, w, 81, C\]'):
        ht._launch_pp_adjoint(torch.zeros(2, 81, 8))
    assert _build.launches['neighbor_pp_adjoint'] == 0


def _seg_args(nc, c=16, dtype=torch.bfloat16):
    P = torch.zeros(1, 2, 2, 9, c, dtype=dtype)
    return (P, torch.ones(c), torch.zeros(c), torch.zeros(c, nc, dtype=dtype),
            torch.zeros(nc), torch.tensor([0], dtype=torch.int32))


@pytest.mark.parametrize('nc,r,match', [(33, 8, '1 to 32 classes'),
                                        (19, 33, 'r ≤ 32'),
                                        (19, 0, 'r ≤ 32')])
def test_k8_wrapper_states_its_limits(nc, r, match):
    """K8 checks its operands before any build: 1–32 classes, r ≤ 32."""
    args = _seg_args(nc)
    dy = torch.zeros(1, 2 * max(r, 1), 2 * max(r, 1), nc, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        ht._launch_backward(*args, dy, 0.1, r)
    assert _build.launches['seg_core_train_backward'] == 0
    assert not _build.design_launches


def test_k8_wrapper_checks_dy():
    with pytest.raises(ValueError, match='dy'):
        ht._launch_backward(*_seg_args(19), torch.zeros(1, 16, 16, 18), 0.1, 8)


@pytest.mark.parametrize('launch', ['forward', 'backward'])
def test_bf16_depth_kernels_take_c_multiple_of_16(launch):
    """K9 and K10 in bf16 run the tensor-core bodies, which take channels in
    16-wide slices: another C raises before any build (f32 takes any)."""
    P = torch.zeros(1, 2, 2, 9, 24, dtype=torch.bfloat16)
    a, seed = torch.zeros(24), torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError, match='C % 16 == 0'):
        if launch == 'forward':
            dk._launch_forward(P, a, a, seed, 0.1, 4)
        else:
            dk._launch_backward(P, a, a, seed,
                                torch.zeros(1, 8, 8, 24, dtype=torch.bfloat16),
                                0.1, 4)
    assert _build.launches['d1_core_train'] == 0
    assert _build.launches['d1_core_train_backward'] == 0


@pytest.mark.parametrize('r', [2, 3, 4, 5, 8, 17, 32])
def test_backward_kron_table_is_the_forwards_operand(r):
    """The [r², 96] bf16 table the backward body reads its kron rows from
    holds what the forward body makes in registers: Ay[p, k / 9]·Ax[q, k %
    9] as an f32 product, rounded once to bf16 (round to nearest even), and
    zeros in the 15 padding columns."""
    ay, ax = headkernels._a2(r), headkernels._a2_dmajor(r)
    k = np.arange(81)
    prod = (ay[:, None, k // 9].astype(np.float32)
            * ax[None, :, k % 9].astype(np.float32)).reshape(r * r, 81)
    want = torch.from_numpy(prod).bfloat16()
    got = headkernels._ayx_bf16_k96(r).bfloat16()
    assert got.shape == (r * r, 96)
    assert torch.equal(got[:, :81], want)
    assert not got[:, 81:].any()
