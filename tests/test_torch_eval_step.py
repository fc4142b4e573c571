"""The port's eval step and metrics against the JAX package on the CPU.

The JAX side is ``bench.py``'s eval step (prepare_batch → ensemble forward →
``confusion_matrix_from_logits`` + depth sum), jitted, in f32. The port's
``EvalStep`` gets the JAX path's corruption draws and the same weights
(``convert.flax_to_torch``). Its confusion matrix must agree within 0.1% of
the pixels: argmax near-ties may flip, and under ``jit`` XLA rounds the
corruption blur's last bit differently (see tests/test_torch_weather.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.data.pipeline import prepare_batch as jprepare_batch
from awsegbench.metrics import iou as jiou
from awsegbench.models import ensemble as jensemble
from awsegbench_torch.convert import flax_to_torch
from awsegbench_torch.eval.step import EvalStep
from awsegbench_torch.metrics import iou
from awsegbench_torch.models.ensemble import EnsembleModel
from awsegbench_torch.ops import attention, headkernels, splat
from test_torch_models import random_variables
from test_torch_weather import _jax_draws

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, W, C = 5, 64, 128, 19


@pytest.fixture(scope='module')
def step_pair():
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    labels = rng.integers(0, C, (B, H, W)).astype(np.int32)
    labels[:, :4, :8] = 255                          # ignored pixels
    wids = np.arange(B, dtype=np.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), B)

    jmodel = jensemble.EnsembleModel(num_classes=C, include_depth=True,
                                     head_mode='faithful')
    variables = random_variables(jmodel, images[:1].astype(np.float32),
                                 train=False)

    def eval_step(v, images, labels, wids, keys):      # bench.py:214-233
        prep = jprepare_batch(images, labels, wids, keys, train=False,
                              include_depth=True)
        out = jmodel.apply(v, prep['image'], train=False)
        return (jiou.confusion_matrix_from_logits(out['segmentation'],
                                                  labels, C),
                out['depth'].astype(jnp.float32).sum())

    with jax.default_matmul_precision('float32'):
        cm, dsum = jax.jit(eval_step)(variables, jnp.asarray(images),
                                      jnp.asarray(labels), jnp.asarray(wids),
                                      keys)
    model = EnsembleModel(num_classes=C, include_depth=True,
                          head_mode='faithful')
    model.load_state_dict(flax_to_torch(variables), strict=True)
    step = EvalStep(model, C, device='cpu', dtype=torch.float32)
    out = step(torch.from_numpy(images), torch.from_numpy(labels),
               torch.from_numpy(wids), draws=_jax_draws(keys, H, W))
    return step, out, np.asarray(cm), float(dsum), labels


def test_eval_step_confusion_matrix_matches_jax(step_pair):
    step, _, cm_jax, _, labels = step_pair
    cm = step.cm.numpy()
    n_valid = int((labels != 255).sum())
    assert cm.dtype == np.int64
    assert cm.sum() == n_valid == int(cm_jax.sum())
    moved = np.abs(cm - cm_jax).sum() / 2
    assert moved <= 1e-3 * n_valid, moved
    assert np.trace(cm) > 0 and (cm.sum(0) > 0).sum() > 2  # not one class


def test_eval_step_depth_sum_matches_jax(step_pair):
    step, out, _, dsum_jax, _ = step_pair
    assert out['depth'].shape == (B, H, W, 1)
    assert np.isfinite(step.dsum.item())
    np.testing.assert_allclose(step.dsum.item(), dsum_jax, rtol=1e-4)


def test_eval_step_on_cpu_launches_no_kernel(step_pair):
    assert attention.sr_attention.launches == 0
    assert headkernels.seg_core.launches == 0
    assert splat.splat_coverage_batched.launches == 0


def test_eval_step_accumulates_and_needs_a_card_unless_cpu(step_pair):
    step, _, _, _, _ = step_pair
    before = step.cm.clone()
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, H, W, 3), dtype=torch.uint8)
    labels = torch.randint(0, C, (2, H, W))
    step(images, labels, torch.tensor([1, 3]), generator=g)
    assert int((step.cm - before).sum()) == 2 * H * W
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            EvalStep(step.model, C)


def test_confusion_matrix_from_logits_ties_and_ignore():
    rng = np.random.default_rng(6)
    logits = rng.integers(0, 3, (2, 9, 11, C)).astype(np.float32)  # ties
    targets = rng.integers(0, C, (2, 9, 11))
    targets[0, :2] = 255
    got = iou.confusion_matrix_from_logits(torch.from_numpy(logits),
                                           torch.from_numpy(targets), C)
    want = jiou.confusion_matrix_from_logits(jnp.asarray(logits),
                                             jnp.asarray(targets), C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_confusion_matrix_nchw_and_iou():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)  # NCHW
    targets = rng.integers(0, 5, (2, 6, 7))
    targets[1, 0] = 255
    got = iou.confusion_matrix(torch.from_numpy(logits),
                               torch.from_numpy(targets), 5)
    want = jiou.confusion_matrix(jnp.asarray(logits), jnp.asarray(targets), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_iou = iou.iou_from_confusion(got)
    want_iou = jiou.iou_from_confusion(want)
    np.testing.assert_allclose(got_iou['per_class_iou'].numpy(),
                               np.asarray(want_iou['per_class_iou']),
                               rtol=1e-6)
    np.testing.assert_allclose(got_iou['mean_iou'].item(),
                               float(want_iou['mean_iou']), rtol=1e-6)
    np.testing.assert_array_equal(got_iou['valid_classes'].numpy(),
                                  np.asarray(want_iou['valid_classes']))
