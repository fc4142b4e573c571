"""Mask2Former-R50's counts: its forward FLOPs (the adapter's sum, in
``counts/mask2former.py``) against torch's FLOP counter over the plain
reference, and K11's operations and bytes by hand."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.common import port, weights
from portbench.counts import mask2former as counts
from portbench.counts import roofline
from portbench.counts.flops import forward_flops
from portbench.reference import model as ref_model

CONFIG = json.loads((harness.HERE / 'configs' / 'mask2former-r50.json')
                    .read_text())


@pytest.mark.parametrize('height,width', [(64, 128), (96, 64)])
def test_forward_flops_match_torch_counter(height, width):
    """Every product the reference computes is counted once: convolutions,
    dense layers, attention's scores and values, the deformable weighted
    sums, the mask and semantic einsums."""
    state = weights.make_state(weights.shapes_of(port.skeleton(CONFIG)), 0,
                               'cpu')
    model = ref_model.build(CONFIG, state, 'cpu')
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros(1, height, width, 3))
    assert forward_flops(CONFIG, height, width) == pytest.approx(
        counter.get_total_flops(), rel=1e-9)


def test_flops_per_image_at_the_cell():
    """The count ``mfu.sweep`` divides by in ``sweep-m2fr50-cityscapes``:
    1.0487 TFLOP an image at 1024×2048, of which the ResNet 0.3417."""
    assert forward_flops(CONFIG, 1024, 2048) / 1e12 == pytest.approx(
        1.0487, abs=5e-5)
    backbone, res = counts.resnet(1024, 2048, CONFIG['backbone'])
    assert backbone / 1e12 == pytest.approx(0.3417, abs=5e-5)
    assert [r[:2] for r in res] == [(256, 512), (128, 256), (64, 128),
                                    (32, 64)]


def test_k11_by_hand():
    # b=1, lq=2, s=5, m=2 heads of d=8, 3 levels of 4 points: 48 points,
    # 5 multiply-adds a point and channel; value and output in bf16, the
    # locations (2 f32) and weights (1 f32) a point
    ops, nbytes = counts.k11_counts(1, 2, 5, 2, 8, 3, 4)
    assert ops == 2 * 5 * 48 * 8
    assert nbytes == 2 * 5 * 2 * 8 + 4 * 48 * 3 + 2 * 2 * 2 * 8
    launch = counts.k11_launch(CONFIG, 4, 1024, 2048)
    assert launch == (4, 43008, 43008, 8, 32, 3, 4)
    ops, nbytes = counts.k11_counts(*launch)
    # value 88 MB, locations 132 MB, weights 66 MB, output 88 MB
    assert nbytes == pytest.approx(374.34e6, rel=1e-4)
    assert roofline.bound(ops, nbytes) == pytest.approx(nbytes / 3.35e12)
