"""Pretrained encoders in the port (``models/convert.py``,
``models/pretrained.py``) against the JAX package's, on the CPU.

The state dicts are synthetic, built from the public key schemas by
``chip_smoke.py``'s generators (the ones its ``pretrained`` phase writes on
the card): a Hugging Face MiT (B0 and the deeper B2), a torchvision
ResNet-50 with ``num_batches_tracked``, and a reference-trained ensemble
made of those two, the port's heads renamed to the reference's
``nn.Sequential`` indices and its ensemble weights.

* The key maps are bit-equal to JAX's ``convert_*`` followed by
  ``flax_to_torch``.
* ``apply_pretrained`` over ``.npz``, ``.pt`` (a ``state_dict`` wrapper,
  the ``segformer.`` prefix) and ``.safetensors`` leaves the encoders as
  JAX's ``apply_pretrained`` on its ensemble's variables, then
  ``flax_to_torch``, bit for bit; the port's own safetensors reader equals ``safetensors.numpy``.
* Per encoder, a missing file, a truncated file and a wrong shape leave that
  encoder at its random init with a warning; the other is grafted.
* ``model.pretrained`` absent means true: the trainer grafts, the evaluate
  CLI does not.
* A grafted ensemble's forward at 64×64 agrees with JAX's within 2e-3.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from awsegbench.models import convert as jconvert
from awsegbench.models import ensemble as jensemble
from awsegbench.models import factory as jfactory
from awsegbench.models import pretrained as jpretrained
from awsegbench_torch.cli import evaluate as eval_cli
from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.models import convert, pretrained
from awsegbench_torch.models.deeplab import ResNetEncoder
from awsegbench_torch.models.ensemble import EnsembleModel
from awsegbench_torch.models.factory import create_model
from awsegbench_torch.models.segformer import MIT_VARIANTS, MiTEncoder
from awsegbench_torch.train.trainer import AdverseWeatherTrainer
from test_torch_models import random_variables

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LOGGER = 'awsegbench_torch.models.pretrained'
ENSEMBLE = {'type': 'ensemble', 'num_classes': 5, 'include_depth': True}


def _equal(got, want):
    """Two state dicts with the same keys, bit for bit."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _jax_to_torch(tree):
    """JAX's converter output (with ResNet's '__batch_stats__') → state
    dict through the port's Flax converter."""
    tree = dict(tree)
    stats = tree.pop('__batch_stats__', None)
    return flax_to_torch({'params': tree, **(
        {'batch_stats': stats} if stats is not None else {})})


@pytest.mark.parametrize('variant,prefix', [('b0', ''),
                                            ('b0', 'segformer.'),
                                            ('b2', 'segformer.')])
def test_hf_segformer_key_map_bit_equal(variant, prefix):
    sd = chip_smoke.mit_state_dict(variant, seed=1, prefix=prefix)
    depths = MIT_VARIANTS[variant][1]
    got = convert.convert_hf_segformer_encoder(sd, depths, prefix)
    _equal(got, _jax_to_torch(jconvert.convert_hf_segformer_encoder(
        sd, depths, prefix)))
    hidden, _ = MIT_VARIANTS[variant]
    MiTEncoder(hidden, depths).load_state_dict(got, strict=True)


def test_resnet_key_map_bit_equal():
    sd = chip_smoke.resnet50_state_dict(seed=2)
    assert any(k.endswith('num_batches_tracked') for k in sd)
    got = convert.convert_torch_resnet_encoder(sd)
    _equal(got, _jax_to_torch(jconvert.convert_torch_resnet_encoder(sd)))
    ResNetEncoder().load_state_dict(got, strict=True)
    assert not any('num_batches_tracked' in k for k in got)
    assert torch.equal(got['BatchNorm_0.running_var'],
                       torch.from_numpy(sd['bn1.running_var']))


# the port's head and decoder scopes → the reference's module names
REFERENCE_NAMES = {
    'segformer.SegmentationHead_0.Conv_0': 'segformer.segmentation_head.0',
    'segformer.SegmentationHead_0.BatchNorm_0': 'segformer.segmentation_head.1',
    'segformer.SegmentationHead_0.Conv_1': 'segformer.segmentation_head.4',
    'deeplabv3plus.ASPP_0.ConvBNReLU_0.Conv_0': 'deeplabv3plus.model.aspp.b0.conv',
    'deeplabv3plus.ASPP_0.ConvBNReLU_0.BatchNorm_0': 'deeplabv3plus.model.aspp.b0.bn',
    'deeplabv3plus.ASPP_0.ConvBNReLU_1.Conv_0': 'deeplabv3plus.model.aspp.pool.conv',
    'deeplabv3plus.ASPP_0.ConvBNReLU_1.BatchNorm_0': 'deeplabv3plus.model.aspp.pool.bn',
    'deeplabv3plus.ASPP_0.ConvBNReLU_2.Conv_0': 'deeplabv3plus.model.aspp.proj.conv',
    'deeplabv3plus.ASPP_0.ConvBNReLU_2.BatchNorm_0': 'deeplabv3plus.model.aspp.proj.bn',
    'deeplabv3plus.ConvBNReLU_0.Conv_0': 'deeplabv3plus.model.low_proj.conv',
    'deeplabv3plus.ConvBNReLU_0.BatchNorm_0': 'deeplabv3plus.model.low_proj.bn',
    'deeplabv3plus.Conv_0': 'deeplabv3plus.model.cls',
    **{f'deeplabv3plus.ASPP_0.SeparableConvBNReLU_{i}.{a}':
       f'deeplabv3plus.model.aspp.sep{i}.{b}' for i in range(3)
       for a, b in (('Conv_0', 'dw'), ('Conv_1', 'pw'), ('BatchNorm_0', 'bn'))},
    **{f'deeplabv3plus.SeparableConvBNReLU_{i}.{a}': f'deeplabv3plus.model.{m}.{b}'
       for i, m in ((0, 'pre'), (1, 'fuse'))
       for a, b in (('Conv_0', 'dw'), ('Conv_1', 'pw'), ('BatchNorm_0', 'bn'))},
    **{f'{m}.DepthEstimationHead_0.{a}': f'{m}.depth_head.depth_head.{i}'
       for m in ('segformer', 'deeplabv3plus')
       for a, i in (('Conv_0', 0), ('BatchNorm_0', 1), ('Conv_1', 4),
                    ('BatchNorm_1', 5), ('Conv_2', 7))},
}


@pytest.fixture(scope='module')
def reference_ensemble():
    """A reference-trained ensemble's state dict and the port model whose
    heads it was renamed from."""
    model = create_model(ENSEMBLE, device='cpu', seed=3)
    ref = {f'segformer.{k}': v for k, v in
           chip_smoke.mit_state_dict('b0', seed=4).items()}
    ref.update({f'deeplabv3plus.model.encoder.{k}': v for k, v in
                chip_smoke.resnet50_state_dict(seed=5).items()})
    for key, value in model.state_dict().items():
        if '.MiTEncoder_0.' in key or '.ResNetEncoder_0.' in key:
            continue
        scope, dot, leaf = key.rpartition('.')
        ref[f'{REFERENCE_NAMES.get(scope, scope)}{dot}{leaf}'] = \
            value.numpy().copy()
    return ref, model


def test_reference_ensemble_key_maps_bit_equal(reference_ensemble):
    ref, model = reference_ensemble
    got = convert.convert_reference_ensemble(ref)
    _equal(got, flax_to_torch(jconvert.convert_reference_ensemble(ref)))
    EnsembleModel(5).load_state_dict(got, strict=True)
    for key, value in model.state_dict().items():     # the renamed heads
        if '.MiTEncoder_0.' not in key and '.ResNetEncoder_0.' not in key:
            assert torch.equal(got[key], value), key
    for member, fn in (('segformer', 'convert_reference_segformer_member'),
                       ('deeplabv3plus', 'convert_reference_deeplab_member')):
        mine = getattr(convert, fn)(ref, prefix=f'{member}.')
        _equal(mine, flax_to_torch(getattr(jconvert, fn)(
            ref, prefix=f'{member}.')))
        _equal(mine, {k[len(member) + 1:]: v for k, v in got.items()
                      if k.startswith(f'{member}.')})


def test_merge_encoder_params():
    target = create_model(ENSEMBLE, device='cpu', seed=6).state_dict()
    enc = convert.convert_hf_segformer_encoder(
        chip_smoke.mit_state_dict('b0', seed=7, prefix=''))
    merged = convert.merge_encoder_params(target, enc,
                                          'segformer.MiTEncoder_0')
    assert merged.keys() == target.keys()
    for k, v in merged.items():
        if k.startswith('segformer.MiTEncoder_0.'):
            assert torch.equal(v, enc[k[len('segformer.MiTEncoder_0.'):]])
        else:
            assert v is target[k]


def _write(weights_dir, fmt, mit, r50):
    """The two encoders' files in ``fmt``: .pt wraps the state dict under
    'state_dict'; every format keeps MiT's 'segformer.' prefix."""
    weights_dir.mkdir(exist_ok=True)
    if fmt == 'npz':
        np.savez(weights_dir / 'segformer_b0.npz', **mit)
        np.savez(weights_dir / 'resnet50.npz', **r50)
    elif fmt == 'pt':
        for name, sd in (('segformer_b0', mit), ('resnet50', r50)):
            torch.save({'state_dict': {k: torch.from_numpy(v)
                                       for k, v in sd.items()}},
                       weights_dir / f'{name}.pt')
    else:
        chip_smoke.write_safetensors(weights_dir / 'segformer_b0.safetensors',
                                     mit)
        chip_smoke.write_safetensors(weights_dir / 'resnet50.safetensors',
                                     {k: v for k, v in r50.items()
                                      if v.dtype == np.float32})


@pytest.fixture(scope='module')
def jax_fresh():
    """A variables tree of JAX's ensemble from its factory, in the shapes
    of its ``init`` at 32×64 (values from ``random_variables``: JAX's
    eager ``init_model`` of the whole ensemble takes most of a minute
    here, and the graft replaces the encoders' values anyway)."""
    jmodel = jfactory.create_model({'model': dict(ENSEMBLE)})
    return jmodel, random_variables(jmodel, np.zeros((1, 32, 64, 3),
                                                     np.float32), train=False)


@pytest.mark.parametrize('fmt', ['npz', 'pt', 'safetensors'])
def test_graft_bit_equal_to_jax(tmp_path, fmt, jax_fresh):
    mit = chip_smoke.mit_state_dict('b0', seed=8)
    r50 = chip_smoke.resnet50_state_dict(seed=9)
    _write(tmp_path / 'w', fmt, mit, r50)
    jmodel, variables = jax_fresh
    jgrafted = flax_to_torch(jax.device_get(jpretrained.apply_pretrained(
        variables, ENSEMBLE, tmp_path / 'w')))
    model = create_model(ENSEMBLE, device='cpu', seed=10)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert pretrained.apply_pretrained(model, ENSEMBLE, tmp_path / 'w') == \
        {'segformer': True, 'resnet': True}
    state = model.state_dict()
    encoders = [k for k in state if '.MiTEncoder_0.' in k
                or '.ResNetEncoder_0.' in k]
    assert len(encoders) == len(convert.convert_hf_segformer_encoder(
        mit, prefix='segformer.')) + len(
        convert.convert_torch_resnet_encoder(r50))
    for k in state:
        want = jgrafted[k] if k in encoders else before[k]
        assert torch.equal(state[k], want), k


def test_safetensors_reader_equals_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import save_file as save_torch
    rng = np.random.default_rng(11)
    arrays = {'a.weight': rng.standard_normal((3, 4, 5)).astype(np.float32),
              'b': rng.standard_normal(7).astype(np.float16),
              'empty': np.zeros((0, 3), np.float32),
              'scalar': np.array(2.5, np.float32)}
    save_file(arrays, str(tmp_path / 'x.safetensors'), metadata={'k': 'v'})
    got = pretrained.read_safetensors(tmp_path / 'x.safetensors')
    want = load_file(str(tmp_path / 'x.safetensors'))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    # the hand-written file of chip_smoke.py reads back through the package
    chip_smoke.write_safetensors(tmp_path / 'y.safetensors', arrays)
    back = load_file(str(tmp_path / 'y.safetensors'))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32))
    # BF16 through a torch view, widened to f32
    bf = torch.randn((4, 6), generator=torch.Generator().manual_seed(0)
                     ).bfloat16()
    save_torch({'w': bf, 'i': torch.arange(3)}, str(tmp_path / 'z.safetensors'))
    with pytest.raises(ValueError, match='I64'):
        pretrained.read_safetensors(tmp_path / 'z.safetensors')
    save_torch({'w': bf}, str(tmp_path / 'z.safetensors'))
    z = pretrained.read_safetensors(tmp_path / 'z.safetensors')
    np.testing.assert_array_equal(z['w'], bf.float().numpy())
    assert z['w'].dtype == np.float32
    raw = (tmp_path / 'z.safetensors').read_bytes()
    (tmp_path / 'z.safetensors').write_bytes(raw[:-8])
    with pytest.raises(ValueError, match='bytes'):
        pretrained.read_safetensors(tmp_path / 'z.safetensors')


@pytest.mark.parametrize('fault', ['missing', 'truncated', 'wrong_shape'])
def test_fallback_per_encoder(tmp_path, caplog, fault):
    """The ResNet file is at fault: DeepLab keeps its random init with a
    warning, MiT is grafted all the same."""
    mit = chip_smoke.mit_state_dict('b0', seed=12)
    r50 = chip_smoke.resnet50_state_dict(seed=13)
    _write(tmp_path, 'npz', mit, r50)
    bad = tmp_path / 'resnet50.npz'
    if fault == 'missing':
        bad.unlink()
    elif fault == 'truncated':
        bad.write_bytes(bad.read_bytes()[:bad.stat().st_size // 2])
    else:
        r50['layer2.0.conv2.weight'] = r50['layer2.0.conv2.weight'][:, :, :2]
        np.savez(bad, **r50)
    model = create_model(ENSEMBLE, device='cpu', seed=14)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        grafted = pretrained.apply_pretrained(model, ENSEMBLE, tmp_path)
    assert grafted == {'segformer': True, 'resnet': False}
    text = caplog.text
    assert ('ResNet-50 weights not found' in text if fault == 'missing'
            else 'Could not load pretrained resnet' in text), text
    if fault == 'wrong_shape':
        assert 'shape mismatch' in text
    state = model.state_dict()
    enc = convert.convert_hf_segformer_encoder(mit, prefix='segformer.')
    for k, v in state.items():
        if k.startswith('segformer.MiTEncoder_0.'):
            assert torch.equal(v, enc[k[len('segformer.MiTEncoder_0.'):]])
        else:
            assert torch.equal(v, before[k]), k


def _trainer_config(**model):
    return {'model': dict(ENSEMBLE, type='segformer', **model),
            'device': 'cpu', 'mlflow': {'enabled': False},
            'tpu': {'precision': 'fp32'}, 'training': {'epochs': 1}}


@pytest.mark.parametrize('pretrained_key', ['absent', True, False])
def test_trainer_grafts_by_default(tmp_path, monkeypatch, pretrained_key):
    mit = chip_smoke.mit_state_dict('b0', seed=15)
    _write(tmp_path / 'w', 'npz', mit, chip_smoke.resnet50_state_dict(16))
    monkeypatch.setenv('AWSEG_WEIGHTS_DIR', str(tmp_path / 'w'))
    extra = {} if pretrained_key == 'absent' else {'pretrained':
                                                   pretrained_key}
    config = _trainer_config(**extra)
    model = create_model(config, device='cpu')
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    AdverseWeatherTrainer(model, [], [], config, device='cpu',
                          checkpoint_dir=str(tmp_path / 'ck'),
                          log_dir=str(tmp_path / 'logs'))
    enc = convert.convert_hf_segformer_encoder(mit, prefix='segformer.')
    state = model.state_dict()
    for k, v in state.items():
        if pretrained_key is not False and k.startswith('MiTEncoder_0.'):
            assert torch.equal(v, enc[k[len('MiTEncoder_0.'):]]), k
        else:
            assert torch.equal(v, fresh[k]), k


def test_evaluate_cli_does_not_graft(tmp_path, monkeypatch):
    _write(tmp_path / 'w', 'npz', chip_smoke.mit_state_dict('b0', seed=17),
           chip_smoke.resnet50_state_dict(18))
    monkeypatch.setenv('AWSEG_WEIGHTS_DIR', str(tmp_path / 'w'))
    config = _trainer_config()
    saved = create_model(config, device='cpu', seed=19).state_dict()
    torch.save(saved, tmp_path / 'model.pt')
    loaded = eval_cli.load_model(str(tmp_path / 'model.pt'), config,
                                 device='cpu').state_dict()
    _equal(loaded, saved)


def test_grafted_forward_matches_jax(tmp_path):
    """The ensemble with both encoders grafted, its other weights JAX's:
    logits within the ensemble's 2e-3."""
    _write(tmp_path, 'npz', chip_smoke.mit_state_dict('b0', seed=20),
           chip_smoke.resnet50_state_dict(21))
    x = np.random.default_rng(22).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    jmodel = jensemble.EnsembleModel(num_classes=5, include_depth=True,
                                     head_mode='faithful')
    variables = random_variables(jmodel, x, train=False)
    jvars = jpretrained.apply_pretrained(variables, ENSEMBLE, tmp_path)
    with jax.default_matmul_precision('float32'):
        want = jmodel.apply(jvars, jnp.asarray(x), train=False)
    model = EnsembleModel(5, True, head_mode='faithful')
    model.load_state_dict(flax_to_torch(variables), strict=True)
    assert pretrained.apply_pretrained(model, ENSEMBLE, tmp_path) == \
        {'segformer': True, 'resnet': True}
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    scale = float(np.abs(np.asarray(want['segmentation'])).max())
    assert 0.1 < scale < 1e3, scale
    for k in ('segmentation', 'segformer_seg', 'deeplabv3plus_seg', 'depth'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-3, atol=2e-3, err_msg=k)
