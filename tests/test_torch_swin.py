"""Mask2Former-Swin (``models/swin.py``, the factory's ``mask2former_swin``)
and its window attention (K15's plain version, ``ops/window_attention.py``)
on the CPU at tiny Swin sizes (embed 32, heads 1, 2, 4, 8 of 32; window 7)
under the head's published widths.

* the window attention against the benchmark's plain reference
  (``portbench/reference/models/swin.py``: ``torch.roll``,
  ``window_partition``, the −100 ``img_mask``, ``window_reverse``), with
  and without the shift, on maps that need padding and one that does not;
  a whole block, whose padding comes after ``norm1``;
* the whole model, on its plain path in f32, against the reference's
  (``portbench/reference/builders/mask2former_swin.py``) on seeded random
  weights, at an input whose stages pad and whose patch merging meets an
  odd side;
* ``create_model`` at the published sizes (on meta): the parameter count
  and the leaves the configuration's sizes name; the relative position
  index and the shift masks kept out of the state dict;
* the traced forward holds one ``awseg::window_attention`` a block and no
  other softmax in the backbone; ``Evaluator.run`` sweeps it, refuses to
  tile it; the evaluate CLI on a saved checkpoint.

Tolerances: the port and the reference compute the same f32 function in
other orders (the port's attention is ``window_attention_plain``, the
reference's the published module), so they agree to about 1e-6 relative;
held at 1e-5, as the R50 model's test holds its own.
"""

import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from awsegbench_torch import _build
from awsegbench_torch.eval.evaluator import Evaluator
from awsegbench_torch.models import mask2former as m2f
from awsegbench_torch.models import swin
from awsegbench_torch.models.factory import create_model
from awsegbench_torch.train.checkpoints import CheckpointManager
from portbench.common import weights
from portbench.models import mask2former_swin as adapter
from portbench.reference.builders import mask2former_swin as ref_builder
from portbench.reference.models import swin as ref_swin

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
C = 5
TINY = {'embed_dim': 32, 'depths': [2, 2, 2, 2], 'heads': [1, 2, 4, 8],
        'window': 7, 'mlp_ratio': 4}
CONFIG = json.loads((ROOT / 'portbench' / 'configs'
                     / 'mask2former-swin-l.json').read_text())
TINY_CONFIG = dict(CONFIG, model={'type': 'mask2former_swin',
                                  'num_classes': C}, swin=TINY)


def rel(a, b):
    return float((a - b).norm() / b.norm())


def reference_windows(x, attn, window, shift):
    """The reference's attention over a padded map x [B, Hp, Wp, C], as its
    block writes it around ``WindowAttention``."""
    b, hp, wp, c = x.shape
    mask = None
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
        mask = ref_swin.shift_attn_mask(hp, wp, window, shift, x.device)
    win = ref_swin.window_partition(x, window).view(-1, window * window, c)
    out = attn(win, mask=mask).view(-1, window, window, c)
    out = ref_swin.window_reverse(out, window, hp, wp)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


@pytest.mark.parametrize('shift', [0, 3])
@pytest.mark.parametrize('h,w', [(14, 21), (11, 17), (5, 9)])
def test_window_attention_matches_the_reference(h, w, shift):
    """(14, 21): whole windows; (11, 17): padded to 14 × 21; (5, 9): one
    window row, padded to 7 × 14."""
    dim, heads = 64, 2
    port = swin.WindowAttention(dim, heads, 7).eval()
    state = weights.make_state(weights.shapes_of(port), 1, 'cpu')
    port.load_state_dict(state)
    ref = ref_swin.WindowAttention(dim, 7, heads).eval()
    ref.load_state_dict(state)
    g = torch.Generator().manual_seed(2)
    x = F.pad(torch.randn(2, h, w, dim, generator=g),
              (0, 0, 0, -w % 7, 0, -h % 7))
    with torch.inference_mode():
        got = port(x, shift)
        want = reference_windows(x, ref, 7, shift)
    assert got.shape == x.shape and _build.launches['window_attention'] == 0
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize('shift', [0, 3])
def test_a_block_pads_after_norm1(shift):
    """The port's block against the reference's on an 11 × 17 map: the
    padded tokens are zeros after ``norm1`` (so they carry the qkv bias;
    padded before it, they would carry the norm's bias) and take part as
    keys."""
    dim, heads = 32, 1
    port = swin.SwinBlock(dim, heads, 7, shift, 4).eval()
    state = weights.make_state(weights.shapes_of(port), 4, 'cpu')
    port.load_state_dict(state)
    ref = ref_swin.SwinTransformerBlock(dim, heads, 7, shift, 4).eval()
    ref.load_state_dict(state)
    x = torch.randn(2, 11, 17, dim, generator=torch.Generator().manual_seed(5))
    mask = ref_swin.shift_attn_mask(14, 21, 7, 3, 'cpu')
    with torch.inference_mode():
        got = port(x)
        want = ref(x.view(2, -1, dim), 11, 17, mask).view(2, 11, 17, dim)
    assert rel(got, want) < 1e-5


def tiny_pair(seed):
    """The port's tiny model (the adapter's skeleton) and the reference's
    (the builder's), holding the same seeded random weights in f32."""
    port = adapter.skeleton(TINY_CONFIG)
    state = weights.make_state(weights.shapes_of(port), seed, 'cpu')
    port.load_state_dict(dict(state), strict=True, assign=True)
    with torch.device('meta'):
        ref = ref_builder.skeleton(TINY_CONFIG)
    ref.load_state_dict({k: v.clone() for k, v in state.items()},
                        strict=True, assign=True)
    return port.eval(), ref.eval()


def test_model_matches_the_reference_in_f32():
    """72 × 104: stage maps 18 × 26 (padded to 21 × 28), 9 × 13 (an odd
    merge), 5 × 7 (an odd merge), 3 × 4 (padded to 7 × 7)."""
    port, ref = tiny_pair(3)
    x = torch.randn(2, 72, 104, 3, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        feats = port.backbone(x.permute(0, 3, 1, 2))
        want_feats = ref.backbone(x.permute(0, 3, 1, 2))
        got = port(x)['segmentation']
        want = ref(x)['segmentation']
    assert [tuple(f.shape[2:]) for f in feats] == [(18, 26), (9, 13), (5, 7),
                                                   (3, 4)]
    for a, b in zip(feats, want_feats):
        assert a.shape == b.shape and rel(a, b) < 1e-5
    assert got.shape == (2, 72, 104, C)
    assert rel(got, want) < 1e-5


def test_create_model_builds_swin_l():
    with torch.device('meta'):
        model = create_model({'type': 'mask2former_swin', 'num_classes': 19},
                             device='meta')
    assert isinstance(model, m2f.Mask2FormerModel) and not model.tileable
    assert sum(p.numel() for p in model.parameters()) == 215_455_112
    assert sum(p.numel() for p in model.backbone.parameters()) == 195_201_204
    sd = model.state_dict()
    sw = CONFIG['swin']
    c, depths, heads, ws = (sw['embed_dim'], sw['depths'], sw['heads'],
                            sw['window'])
    assert sd['backbone.patch_embed.proj.weight'].shape == (c, 3, 4, 4)
    assert sd['backbone.patch_embed.norm.weight'].shape == (c,)
    for i, (depth, h) in enumerate(zip(depths, heads)):
        ci = c * 2 ** i
        assert len(model.backbone.layers[i].blocks) == depth
        last = f'backbone.layers.{i}.blocks.{depth - 1}.'
        assert sd[last + 'attn.relative_position_bias_table'].shape == (
            (2 * ws - 1) ** 2, h)
        assert sd[last + 'attn.qkv.weight'].shape == (3 * ci, ci)
        assert sd[last + 'attn.proj.weight'].shape == (ci, ci)
        assert sd[last + 'mlp.fc1.weight'].shape == (
            sw['mlp_ratio'] * ci, ci)
        assert sd[f'backbone.norm{i}.weight'].shape == (ci,)
        down = f'backbone.layers.{i}.downsample.'
        if i < len(depths) - 1:
            assert sd[down + 'norm.weight'].shape == (4 * ci,)
            assert sd[down + 'reduction.weight'].shape == (2 * ci, 4 * ci)
            assert down + 'reduction.bias' not in sd
        else:
            assert down + 'norm.weight' not in sd
    assert model.pixel_decoder.adapter_1.in_channels == c
    assert [p[0].in_channels for p in model.pixel_decoder.input_proj] == [
        8 * c, 4 * c, 2 * c]
    assert model.predictor.query_feat.weight.shape == (100, 256)
    assert len(model.predictor.transformer_ffn_layers) == 9
    # the index and the masks are computed: no leaf of the state dict
    assert not any('relative_position_index' in k or 'attn_mask' in k
                   for k in sd)
    assert not list(model.buffers())


def test_seeded_init_draws_the_bias_tables():
    model = create_model({'type': 'mask2former_swin', 'num_classes': C,
                          'swin': TINY}, device='cpu', seed=0)
    table = model.backbone.layers[0].blocks[1].attn \
        .relative_position_bias_table.detach()
    assert table.shape == (169, 1)
    assert 0.01 < float(table.std()) < 0.03
    assert float(table.abs().max()) <= 0.04
    assert model.backbone.layers[0].downsample.reduction.bias is None


def test_the_traced_forward_holds_the_op_once_a_block():
    """No plain window attention in the graph: a moved trace would run
    it on the card."""
    model = create_model({'type': 'mask2former_swin', 'num_classes': C,
                          'swin': TINY}, device='cpu', seed=1)
    x = torch.randn(1, 3, 56, 84)
    gm = torch.fx.experimental.proxy_tensor.make_fx(model.backbone)(x)
    targets = Counter(str(n.target) for n in gm.graph.nodes
                      if n.op == 'call_function')
    assert targets['awseg.window_attention.default'] == 8
    assert not any('softmax' in t for t in targets)


def tiny_batches(n, b=2, h=64, w=96):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        label = rng.integers(0, C, (b, h, w)).astype(np.int32)
        label[:, :3] = 255
        out.append({'image': rng.integers(0, 256, (b, h, w, 3),
                                          dtype=np.uint8),
                    'label': label, 'weather_id': (np.arange(b) + i) % 5,
                    'sample_id': np.arange(b) + i * b})
    return out


def test_evaluator_sweeps_it_and_refuses_to_tile_it():
    cfg = {'type': 'mask2former_swin', 'num_classes': C, 'swin': TINY}
    model = create_model(cfg, device='cpu', seed=1)
    ev = Evaluator(model, {'model': cfg, 'tpu': {'precision': 'fp32'}},
                   device='cpu')
    batches = tiny_batches(2)
    res = ev.run(batches, seed=0)
    assert 0.0 <= res['overall_miou'] <= 1.0
    assert 'ensemble_disagreement_auroc' not in res
    valid = sum(int((b['label'] != 255).sum()) for b in batches)
    assert int(ev.last_acc['cm'].sum()) == valid
    assert int(ev.last_acc['ece'][..., 0].sum()) == valid
    assert not ev.use_tiling(2048, 1024)
    with pytest.raises(ValueError, match='Mask2FormerModel cannot be run on '
                                         'tiles'):
        Evaluator(model, {'model': cfg,
                          'evaluation': {'spatial_tiling': 'on'}},
                  device='cpu')


def test_evaluate_cli_on_a_saved_checkpoint(tmp_path):
    model_cfg = {'type': 'mask2former_swin', 'num_classes': C, 'swin': TINY}
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
    assert res['_num_images'] == 20
    assert all(np.isfinite(v) for v in res.values())
