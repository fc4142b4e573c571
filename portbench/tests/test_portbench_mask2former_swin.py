"""Mask2Former-Swin-L's configuration, counts and reference: the file's
sizes against the model the port builds, its forward FLOPs (the adapter's
sum, in ``counts/swin.py``) against torch's FLOP counter over the plain
reference at tiny Swin sizes, K15's operations and bytes by hand, and the
reference's files importing nothing of the port."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.common import port, weights
from portbench.counts import roofline
from portbench.counts import swin as counts
from portbench.counts.flops import forward_flops
from portbench.models import adapter
from portbench.reference import model as ref_model
from portbench.tests.test_portbench_imports import imported, relative

CONFIG = json.loads((harness.HERE / 'configs' / 'mask2former-swin-l.json')
                    .read_text())
TINY = dict(CONFIG, swin={'embed_dim': 32, 'depths': [2, 1, 2, 1],
                          'heads': [1, 2, 4, 8], 'window': 7,
                          'mlp_ratio': 4})


def test_config_sizes_are_the_built_model():
    sizes = adapter(CONFIG).sizes(port.skeleton(CONFIG))
    assert sizes['swin'] == CONFIG['swin'] == {
        'embed_dim': 192, 'depths': [2, 2, 18, 2], 'heads': [6, 12, 24, 48],
        'window': 12, 'mlp_ratio': 4}
    for section in ('pixel_decoder', 'decoder'):
        assert sizes[section] == CONFIG[section]
    assert sizes['model'] == {'num_classes': 19}
    assert CONFIG['reduced'] == []


@pytest.mark.parametrize('height,width', [(72, 104), (64, 128)])
def test_forward_flops_match_torch_counter(height, width):
    """Every product the reference computes is counted once: the patch
    embedding, qkv and the projections over the padded maps, the windows'
    scores and values, the MLPs, the mergings, and the R50's head."""
    state = weights.make_state(weights.shapes_of(port.skeleton(TINY)), 0,
                               'cpu')
    model = ref_model.build(TINY, state, 'cpu')
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros(1, height, width, 3))
    assert forward_flops(TINY, height, width) == pytest.approx(
        counter.get_total_flops(), rel=1e-9)


def test_flops_per_image_at_the_cell():
    """The count ``mfu.sweep`` divides by in ``sweep-m2fswinl-cityscapes``:
    3.8083 TFLOP an image at 1024×2048, of which the Swin-L 3.1093."""
    assert forward_flops(CONFIG, 1024, 2048) / 1e12 == pytest.approx(
        3.8083, abs=5e-5)
    backbone, res = counts.swin(1024, 2048, CONFIG['swin'])
    assert backbone / 1e12 == pytest.approx(3.1093, abs=5e-5)
    assert res == [(256, 512, 192), (128, 256, 384), (64, 128, 768),
                   (32, 64, 1536)]


def test_k15_by_hand():
    # b=1 over a 14×21 padded map, 2 heads of 32, window 7: 294 tokens,
    # 49 keys each; q, k, v and the output in bf16, the 13×13 table
    ops, nbytes = counts.k15_counts(1, 14, 21, 2, 7)
    assert ops == 4 * 294 * 49 * 64
    assert nbytes == 2 * 4 * 294 * 64 + 2 * 169 * 2
    launches = counts.k15_launches(CONFIG, 4, 1024, 2048)
    assert len(launches) == 24
    assert launches[0] == (4, 264, 516, 6, 12)
    assert launches[4] == (4, 72, 132, 24, 12)
    assert launches[-1] == (4, 36, 72, 48, 12)
    least = [roofline.bound(*counts.k15_counts(*x)) for x in launches]
    # bytes bound every launch: 0.250, 0.128, 0.070 and 0.038 ms a stage
    assert [round(1e3 * least[i], 3) for i in (0, 2, 4, 22)] == [
        0.250, 0.128, 0.070, 0.038]
    assert 1e3 * sum(least) == pytest.approx(2.0866, abs=1e-4)


@pytest.mark.parametrize('name', ['models/swin.py',
                                  'builders/mask2former_swin.py'])
def test_reference_imports_nothing_of_the_port(name):
    path = harness.HERE / 'reference' / name
    assert imported(path) <= {'torch', 'typing', '__future__'}
    assert all(n.startswith('portbench.reference.') for n in relative(path))
