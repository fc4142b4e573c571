"""The port's serving export (``awsegbench_torch/serving.py``) on the CPU,
case for case with tests/test_serving.py, on a tiny
``EnsembleModel(num_classes=5)`` at 32×64.

* A loaded artifact reproduces the in-process serving forward
  (``build_serving_fn``) within JAX's 5e-5; a bf16 export runs and returns
  f32; the static shape is enforced; a ``'poly'`` artifact serves batches 1
  and 3 and refuses 16×64; an export without depth has no depth.
* The platforms contract: a ``('cpu', 'cuda')`` artifact records both,
  ``load(device='cuda')`` raises on a host without a card, a device the
  artifact does not list raises, and ``'tpu'`` is refused.
* ``ServingModel.load`` in a fresh process imports no model code, nor JAX.

JAX parity and the export CLI are in tests/test_torch_serving_parity.py.
The exports and loads are shared through module fixtures (an export of
this model takes about 12 s on one CPU thread, a load about 4 s).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from awsegbench_torch.models.ensemble import EnsembleModel
from awsegbench_torch.serving import (ServingModel, build_serving_fn,
                                      export_serving, save_serving_artifact)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = Path(__file__).resolve().parents[1]
HW = (32, 64)


def _images(batch, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (batch, *HW, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope='module')
def tiny():
    torch.manual_seed(0)
    return EnsembleModel(num_classes=5, include_depth=True).eval()


def _export(model, root, name, batch, **kwargs):
    blob = export_serving(model, HW, batch_size=batch, **kwargs)
    return save_serving_artifact(root / name, blob,
                                 {'input_shape': [batch, *HW, 3],
                                  'num_classes': 5})


@pytest.fixture(scope='module')
def fixed2(tiny, tmp_path_factory):
    return _export(tiny, tmp_path_factory.mktemp('fixed2'), 'a', 2,
                   precision='fp32')


@pytest.fixture(scope='module')
def poly(tiny, tmp_path_factory):
    return _export(tiny, tmp_path_factory.mktemp('poly'), 'a', 'poly',
                   precision='fp32', platforms=('cpu', 'cuda'))


@pytest.fixture(scope='module')
def loaded(fixed2, poly):
    return {'fixed2': ServingModel.load(fixed2),
            'poly': ServingModel.load(poly, device='cpu')}


class TestServingExport:
    def test_roundtrip_matches_direct_forward(self, tiny, loaded):
        x = _images(2)
        serve = build_serving_fn(tiny, precision='fp32')
        direct = serve(torch.from_numpy(x))
        res = loaded['fixed2'].predict(x)

        assert res['segmentation'].shape == (2, *HW, 5)
        assert res['depth'].shape == (2, *HW, 1)
        for key in ('segmentation', 'depth'):
            np.testing.assert_allclose(res[key].numpy(),
                                       direct[key].numpy(), atol=5e-5)

    def test_bf16_policy_export_runs(self, tiny, tmp_path):
        out = _export(tiny, tmp_path, 'bf16', 1, precision='bf16')
        res = ServingModel.load(out).predict(np.zeros((1, *HW, 3), np.uint8))
        # logits come back f32 regardless of the compute dtype
        assert res['segmentation'].dtype == torch.float32
        assert torch.isfinite(res['segmentation']).all()

    def test_build_serving_fn_leaves_the_model(self, tiny):
        serve = build_serving_fn(tiny, precision='bf16')
        assert all(p.dtype == torch.bfloat16 and not p.requires_grad
                   for p in serve.parameters())
        assert all(p.dtype == torch.float32 and p.requires_grad
                   for p in tiny.parameters())

    def test_static_shape_enforced(self, loaded):
        with pytest.raises(ValueError, match='static at export'):
            loaded['fixed2'].predict(np.zeros((1, *HW, 3), np.uint8))
        with pytest.raises(ValueError, match='static at export'):
            loaded['fixed2'].predict(np.zeros((2, *HW, 3), np.float32))

    def test_platforms_contract(self, tiny, fixed2, poly, loaded):
        """A ('cpu', 'cuda') artifact records both; loading it on the card,
        which is the default when the artifact lists the card, needs a card;
        an artifact that lists the CPU alone loads there by default; a
        device it does not list is refused at load, and the TPU is no
        platform of the port."""
        assert loaded['poly'].platforms == ('cpu', 'cuda')
        assert loaded['fixed2'].platforms == ('cpu',)
        assert loaded['fixed2'].device == torch.device('cpu')
        for device in ('cuda', None):
            with pytest.raises(RuntimeError, match='no CUDA device'):
                ServingModel.load(poly, device=device)
        with pytest.raises(ValueError, match='exported for'):
            ServingModel.load(fixed2, device='meta')
        with pytest.raises(ValueError, match='platforms'):
            export_serving(tiny, HW, platforms=('tpu',))

    def test_batch_polymorphic_export(self, loaded):
        """batch_size='poly': one artifact serves any batch size."""
        for bs in (1, 3):
            res = loaded['poly'].predict(np.zeros((bs, *HW, 3), np.uint8))
            assert res['segmentation'].shape == (bs, *HW, 5)
        with pytest.raises(ValueError, match='static at export'):
            loaded['poly'].predict(np.zeros((1, 16, 64, 3), np.uint8))

    def test_no_depth_export(self, tiny, tmp_path):
        out = _export(tiny, tmp_path, 'nodepth', 1, precision='fp32',
                      include_depth=False)
        res = ServingModel.load(out).predict(np.zeros((1, *HW, 3), np.uint8))
        assert set(res) == {'segmentation'}


def test_load_imports_no_model_code(poly):
    """Serving needs only torch and the port's ops: a fresh process loads
    and runs the artifact without importing the models, JAX or the JAX
    package."""
    code = f'''
import sys
import numpy as np
sys.path.insert(0, {str(ROOT)!r})
from awsegbench_torch.serving import ServingModel
res = ServingModel.load({str(poly)!r}, device='cpu').predict(
    np.zeros((1, 32, 64, 3), np.uint8))
assert tuple(res['segmentation'].shape) == (1, 32, 64, 5)
bad = sorted(m for m in sys.modules
             if m.startswith('awsegbench_torch.models')
             or m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'awsegbench'))
print('BAD', bad)
'''
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert 'BAD []' in r.stdout, r.stdout
