"""Mask2Former-R50 (``models/mask2former.py``) and its deformable sampling
(K11's plain version, ``ops/ms_deform_attn.py``) on the CPU at small
inputs (the published widths at 64×128 or 32×64).

* the plain sampling against a bilinear loop written out point by point,
  with points outside the map and on its edges;
* the whole model, on its plain path in f32, against the benchmark's plain
  reference (``portbench/reference/models/mask2former.py``) on seeded
  random weights: the semantic scores and every decoder layer's mask
  logits;
* the attention mask's rule (a query blocking every key attends to all);
* the published grid in ``sampling_offsets.bias`` on both sides after a
  ``load_state_dict(..., assign=True)`` onto the meta device;
* ``create_model``, ``Evaluator.run`` (confusion and ECE, no
  disagreement), the refusal to tile, the evaluate CLI on a saved
  checkpoint and the ResNet graft's fallback.
"""

import json
import logging
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from awsegbench_torch import _build
from awsegbench_torch.core.mesh import DataMesh
from awsegbench_torch.eval.evaluator import Evaluator
from awsegbench_torch.models import mask2former as m2f
from awsegbench_torch.models.factory import create_model
from awsegbench_torch.models.pretrained import apply_pretrained
from awsegbench_torch.ops import ms_deform_attn as msda
from awsegbench_torch.train.checkpoints import CheckpointManager
from portbench.common import weights
from portbench.models import mask2former as adapter
from portbench.reference.builders import mask2former as ref_builder
from portbench.reference.models import mask2former as ref_m2f

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
C = 5


def sample_loop(value, shapes, loc, attn):
    """The sampling written out: each query, head, level and point read at
    pixel (x·W − 0.5, y·H − 0.5) from its four neighbours by the bilinear
    weights, a neighbour outside the map reading 0."""
    b, _, m, d = value.shape
    lq, n_levels, n_points = loc.shape[1], loc.shape[3], loc.shape[4]
    sizes = msda.level_sizes(shapes)
    out = torch.zeros(b, lq, m, d, dtype=torch.float64)
    v = value.double()
    for bi in range(b):
        for q in range(lq):
            for h in range(m):
                start = 0
                for lv, (hl, wl) in enumerate(sizes):
                    for p in range(n_points):
                        x = float(loc[bi, q, h, lv, p, 0]) * wl - 0.5
                        y = float(loc[bi, q, h, lv, p, 1]) * hl - 0.5
                        x0, y0 = math.floor(x), math.floor(y)
                        for yy, xx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0),
                                       (y0 + 1, x0 + 1)):
                            if 0 <= yy < hl and 0 <= xx < wl:
                                wgt = (1 - abs(y - yy)) * (1 - abs(x - xx))
                                out[bi, q, h] += (float(attn[bi, q, h, lv, p])
                                                  * wgt
                                                  * v[bi, start + yy * wl + xx,
                                                      h])
                    start += hl * wl
    return out.reshape(b, lq, m * d)


def test_plain_sampling_matches_the_written_out_loop():
    g = torch.Generator().manual_seed(0)
    shapes = (3, 4, 2, 5)
    b, m, d, n_levels, n_points, lq = 2, 2, 3, 2, 3, 5
    value = torch.randn(b, 3 * 4 + 2 * 5, m, d, generator=g)
    loc = torch.rand(b, lq, m, n_levels, n_points, 2, generator=g) * 1.6 - 0.3
    loc[0, 0, 0, 0, 0] = torch.tensor([0.0, 0.0])       # a corner
    loc[0, 1, 0, 0, 0] = torch.tensor([1.0, 0.5])       # the right edge
    loc[0, 2, 1, 1, 1] = torch.tensor([0.5, 1.0])       # the bottom edge
    loc[1, 0, 0, 0, 0] = torch.tensor([-0.5, 0.5])      # wholly outside
    attn = torch.softmax(torch.randn(b, lq, m, n_levels * n_points,
                                     generator=g), -1).view(
        b, lq, m, n_levels, n_points)
    got = msda.ms_deform_attn(value, shapes, loc, attn)
    assert got.dtype == torch.float32
    assert _build.launches['ms_deform_attn'] == 0
    torch.testing.assert_close(got.double(), sample_loop(value, shapes, loc,
                                                         attn),
                               rtol=1e-5, atol=1e-6)


def test_plain_sampling_rounds_once_to_bf16():
    g = torch.Generator().manual_seed(1)
    value = torch.randn(1, 12, 2, 8, generator=g).to(torch.bfloat16)
    loc = torch.rand(1, 4, 2, 1, 2, 2, generator=g)
    attn = torch.softmax(torch.randn(1, 4, 2, 1, 2, generator=g), -1)
    got = msda.ms_deform_attn(value, (3, 4), loc, attn)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, msda.ms_deform_attn_plain(value.float(), [3, 4],
                                                      loc, attn)
                       .to(torch.bfloat16))


def test_model_matches_the_reference_in_f32():
    """Both sides hold the same seeded random weights, in f32 at 64×128."""
    port = m2f.Mask2FormerModel(C).eval()
    state = weights.make_state(weights.shapes_of(port), 3, 'cpu')
    port.load_state_dict(state)
    ref = ref_m2f.Mask2FormerModel(C).eval()
    ref.load_state_dict(state)
    masks = []
    predict = port.predictor.predict_masks

    def kept(*args):
        out = predict(*args)
        masks.append(out[0])
        return out
    port.predictor.predict_masks = kept
    x = torch.randn(2, 64, 128, 3, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        got = port(x)['segmentation']
        want = ref(x)['segmentation']
    assert got.shape == (2, 64, 128, C)
    assert float((got - want).norm() / want.norm()) < 1e-5
    assert len(masks) == len(ref.predictor.layer_masks) == 10
    for a, b in zip(masks, ref.predictor.layer_masks):
        assert float((a - b).norm() / b.norm()) < 1e-5


def test_a_row_that_blocks_every_key_attends_to_all():
    g = torch.Generator().manual_seed(5)
    masks = torch.randn(2, 4, 8, 16, generator=g)
    masks[0, 1] = -torch.rand(8, 16, generator=g) - 0.1     # all blocked
    masks[1, 3] = torch.rand(8, 16, generator=g) + 0.1      # none blocked
    keep = m2f.attention_keep(masks, (4, 8))
    small = F.interpolate(masks, size=(4, 8), mode='bilinear',
                          align_corners=False)
    # the published form: sigmoid < 0.5 blocks; a full row is unblocked
    blocked = small.sigmoid().flatten(2) < 0.5
    blocked[torch.where(blocked.sum(-1) == blocked.shape[-1])] = False
    assert keep.shape == (2, 1, 4, 32)
    assert torch.equal(keep[:, 0], ~blocked)
    assert keep[0, 0, 1].all() and keep[1, 0, 3].all()


def test_grid_is_in_the_bias_on_both_sides_after_assign():
    config = json.loads((ROOT / 'portbench' / 'configs'
                         / 'mask2former-r50.json').read_text())
    port = adapter.skeleton(config)
    state = weights.make_state(weights.shapes_of(port), 6, 'cpu')
    port.load_state_dict(dict(state), strict=True, assign=True)
    with torch.device('meta'):
        ref = ref_builder.skeleton(config)
    ref.load_state_dict({k: v.clone() for k, v in state.items()},
                        strict=True, assign=True)
    key = 'pixel_decoder.transformer.layers.{}.self_attn.sampling_offsets.bias'
    port_grid = m2f.sampling_grid(8, 3, 4)
    ref_grid = ref_m2f.sampling_grid(8, 3, 4)
    torch.testing.assert_close(port_grid, ref_grid, rtol=0, atol=1e-5)
    assert float(port_grid.abs().max()) == 4.0
    for i in range(6):
        drawn = state[key.format(i)]
        torch.testing.assert_close(port.state_dict()[key.format(i)],
                                   drawn + port_grid)
        torch.testing.assert_close(ref.state_dict()[key.format(i)],
                                   drawn + ref_grid)
    # the drawn state is left as it was
    assert float(state[key.format(0)].abs().max()) < 0.2


def test_create_model_builds_the_published_architecture():
    model = create_model({'type': 'mask2former', 'num_classes': 19},
                         device='cpu', seed=0)
    assert isinstance(model, m2f.Mask2FormerModel) and not model.training
    assert sum(p.numel() for p in model.parameters()) == 44_007_700
    enc = model.pixel_decoder.transformer
    assert len(enc.layers) == 6 and len(model.predictor
                                        .transformer_ffn_layers) == 9
    attn = enc.layers[0].self_attn
    assert torch.equal(attn.sampling_offsets.bias, attn.grid())
    assert not attn.sampling_offsets.weight.any()
    assert model.predictor.query_feat.weight.shape == (100, 256)
    assert model.predictor.class_embed.out_features == 20
    stride = model.backbone.Bottleneck_13.ConvBNReLU_1.Conv_0.stride
    assert stride == (2, 2)                      # res5 at 1/32


def tiny_batches(n, b=2, h=64, w=128):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        label = rng.integers(0, C, (b, h, w)).astype(np.int32)
        label[:, :3] = 255
        out.append({'image': rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
                    'label': label, 'weather_id': (np.arange(b) + i) % 5,
                    'sample_id': np.arange(b) + i * b})
    return out


def test_evaluator_sweeps_it_on_the_cpu():
    model = create_model({'type': 'mask2former', 'num_classes': C},
                         device='cpu', seed=1)
    ev = Evaluator(model, {'model': {'num_classes': C},
                           'tpu': {'precision': 'fp32'}}, device='cpu')
    batches = tiny_batches(2)
    res = ev.run(batches, seed=0)
    assert 0.0 <= res['overall_miou'] <= 1.0
    assert 0.0 <= res['expected_calibration_error'] <= 1.0
    assert 'ensemble_disagreement_auroc' not in res
    valid = sum(int((b['label'] != 255).sum()) for b in batches)
    assert int(ev.last_acc['cm'].sum()) == valid
    assert int(ev.last_acc['ece'][..., 0].sum()) == valid
    assert int(ev.last_acc['auroc_hist'].sum()) == 0


@pytest.mark.parametrize('tiling,ranks', [('auto', 2), ('on', 2), ('on', 1)])
def test_evaluator_refuses_to_tile_it(tiling, ranks):
    """'on' is refused by name; 'auto' and 'off' run the model whole on
    each rank, even at 2048×1024 over two ranks, where 'auto' tiles a
    model that can be tiled."""
    model = m2f.Mask2FormerModel(C)
    mesh = DataMesh(rank=0, size=ranks)
    if tiling == 'on':
        with pytest.raises(ValueError, match="Mask2FormerModel cannot be "
                                             "run on tiles"):
            Evaluator(model, {'model': {'num_classes': C},
                              'evaluation': {'spatial_tiling': tiling}},
                      device='cpu', mesh=mesh)
        return
    for cfg in ({'spatial_tiling': tiling}, {'spatial_tiling': 'off'}):
        ev = Evaluator(model, {'model': {'num_classes': C},
                               'evaluation': cfg}, device='cpu', mesh=mesh)
        assert not ev.use_tiling(2048, 1024)
    tileable = Evaluator(create_model({'type': 'deeplabv3plus',
                                       'num_classes': C}, device='cpu'),
                         {'model': {'num_classes': C},
                          'evaluation': {'spatial_tiling': tiling}},
                         device='cpu', mesh=mesh)
    assert tileable.use_tiling(2048, 1024)


def test_evaluate_cli_on_a_saved_checkpoint(tmp_path, caplog):
    model_cfg = {'type': 'mask2former', 'num_classes': C}
    model = create_model(model_cfg, device='cpu', seed=2)
    CheckpointManager(str(tmp_path / 'ckpt')).save(
        0, {'state_dict': model.state_dict()}, None, {}, {})
    cfg = tmp_path / 'cfg.yaml'
    cfg.write_text(yaml.safe_dump({
        'model': model_cfg, 'device': 'cpu',
        'data': {'data_root': str(tmp_path / 'absent'),
                 'image_size': [32, 64], 'include_depth': False},
        'training': {'batch_size': 10},
        'tpu': {'precision': 'fp32'}}))
    r = subprocess.run(
        [sys.executable, '-m', 'awsegbench_torch.cli.evaluate',
         str(tmp_path / 'ckpt' / 'latest'), '--config', str(cfg),
         '--output-dir', str(tmp_path / 'eval'), '--device', 'cpu'],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, 'PYTHONPATH': str(ROOT), 'OMP_NUM_THREADS': '1'})
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads((tmp_path / 'eval' / 'evaluation_results.json')
                     .read_text())
    assert res['_num_images'] == 20 and 'ensemble_disagreement_auroc' \
        not in res
    assert all(np.isfinite(v) for v in res.values())
    # the ResNet graft of the new type: no weights file, a warning, the
    # random init kept
    before = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        grafted = apply_pretrained(model, model_cfg, tmp_path / 'absent')
    assert grafted == {'resnet': False}
    assert 'ResNet-50 weights not found' in caplog.text
    assert all(torch.equal(v, model.backbone.state_dict()[k])
               for k, v in before.items())
