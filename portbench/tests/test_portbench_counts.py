"""The FLOP and byte counts against hand counts and torch's FLOP counter
at small shapes."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.common import port, weights
from portbench.counts import flops, roofline
from portbench.reference import model as ref_model
from portbench.tests.conftest import single_configs


def test_bound_is_the_larger():
    assert roofline.bound(989e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound(0.0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound(989e12, 6.7e12) == pytest.approx(2.0)


def test_k1_by_hand():
    # g=2, n=3, m=5, d=4: q·kᵀ and p·v, 2·2·3·5·4 each; q, k, v, out in bf16
    assert roofline.k1_counts(2, 3, 5, 4) == (480.0, 2.0 * (48 + 80))
    launches = roofline.k1_launches(1, 64, 128, (32, 64, 160, 256),
                                    (2, 2, 2, 2), (1, 2, 5, 8), (8, 4, 2, 1))
    assert launches[0] == (1, 16 * 32, 2 * 4, 32)
    assert launches[-1] == (8, 2 * 4, 2 * 4, 32) and len(launches) == 8


def test_seg_and_k8_by_hand():
    # b=1, h=w=1, c=2, nc=3, r=4: 16 fine pixels
    f, nbytes = roofline.seg_counts(1, 1, 1, 2, 3, 4)
    assert f == 16 * (2 * 81 * 2 / 4 + 2 * 9 * 2 + 2 * 2 * 3)
    assert nbytes == 9 * 2 * 2 + 2 * 3 * 2 + 16 * 3 * 2
    f8, b8 = roofline.k8_counts(1, 1, 1, 2, 3, 4)
    assert f8 == 2 * f
    assert b8 == 36 + 16 * 3 * 2 + 9 * 36 + (4 + 6 + 3) * 4


def test_conv_by_hand():
    assert flops.conv(2, 3, 4, 5, 3) == 2 * 2 * 3 * 4 * 5 * 9
    assert flops.conv(2, 3, 8, 8, 3, groups=8) == 2 * 2 * 3 * 8 * 9


def test_upsample_conv_by_hand():
    # f [1, 1, 2, 3], r=4: 2·2·3·27 partial products, then 9 taps on the
    # y pass's 4·1·3·3 and on the x pass's 4·4·3 elements, 2 FLOPs each
    assert flops.upsample_conv(1, 1, 2, 3, 4) == (
        2 * 2 * 27 + 2 * 9 * 4 * 3 * 3 + 2 * 9 * 4 * 4 * 3)


def upsample_convs(cfg, height, width):
    """The (phase-form, full-resolution) FLOPs of the faithful heads'
    upsample-convs at ``height`` × ``width`` (none without SegFormer)."""
    if 'segformer' not in cfg:
        return 0.0, 0.0
    sf, r = cfg['segformer'], 32
    cin = sf['hidden_sizes'][-1]
    outs = [sf['seg_head_hidden'], sf['depth_head_hidden']]
    phase = sum(flops.upsample_conv(height // r, width // r, cin, o, r)
                for o in outs)
    full = sum(flops.conv(height, width, cin, o, 3) for o in outs)
    return phase, full


def config_of(variant):
    """The ensemble's configuration at MiT ``variant`` ('b0', 'b1'), or a
    single-model configuration by name."""
    if variant in single_configs():
        return single_configs()[variant]
    cfg = json.loads((harness.HERE / 'configs' / 'ensemble-b0-r50.json')
                     .read_text())
    if variant == 'b1':
        cfg['model']['segformer_variant'] = 'b1'
        cfg['segformer']['hidden_sizes'] = [64, 128, 320, 512]
    return cfg


@pytest.mark.parametrize('variant', ['b0', 'b1', 'segformer-b0',
                                     'deeplabv3plus-r50'])
def test_forward_flops_match_torch_counter(variant):
    """The analytic count (the sum the model type's adapter makes) equals
    torch's FLOP counter over the plain reference's forward at 64×128, once
    the faithful heads' upsample-convs are taken at full resolution, as the
    reference computes them (the count takes their phase form, checked by
    hand above)."""
    cfg = config_of(variant)
    state = weights.make_state(weights.shapes_of(port.skeleton(cfg)), 0,
                               'cpu')
    model = ref_model.build(cfg, state, 'cpu')
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros(1, 64, 128, 3))
    phase, full = upsample_convs(cfg, 64, 128)
    assert flops.forward_flops(cfg, 64, 128) - phase + full == pytest.approx(
        counter.get_total_flops(), rel=1e-3)


def test_ensemble_is_the_sum_of_its_members():
    ens = config_of('b0')
    assert flops.forward_flops(ens, 512, 1024) == (
        flops.forward_flops(config_of('segformer-b0'), 512, 1024)
        + flops.forward_flops(config_of('deeplabv3plus-r50'), 512, 1024))


@pytest.mark.parametrize('name,gflops', [('ensemble-b0-r50', 271.4),
                                         ('ensemble-b5-r50', 573.5)])
def test_flops_per_image_stay(name, gflops):
    """The counts the cells' ``mfu`` readers divide by, at 512×1024."""
    cfg = json.loads((harness.HERE / 'configs' / f'{name}.json').read_text())
    assert flops.forward_flops(cfg, 512, 1024) / 1e9 == pytest.approx(
        gflops, abs=0.05)
