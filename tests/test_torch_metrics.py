"""The port's metrics against the JAX package's, on the CPU.

Every function of ``awsegbench_torch/metrics`` gets the same numpy inputs,
made from a seed, as its JAX counterpart. Tolerances: counts exactly (the
port counts in int64, JAX in f32, exact at these sizes); f32 maps, ECE and
both AUROCs within 1e-6; the ECE bins' f32 confidence sums within 1e-6
relative (the two frameworks add in another order). Log-scale histograms
are compared by their AUROC, not bin for bin: a score on a bin edge may
land one bin over where torch's and XLA's ``log`` differ in the last
place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awsegbench.metrics import calibration as jcal
from awsegbench.metrics import disagreement as jdis
from awsegbench.metrics import iou as jiou
from awsegbench.metrics import robustness as jrob
from awsegbench_torch import metrics
from awsegbench_torch.metrics import calibration, disagreement, iou

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H, W, C, NW = 5, 6, 7, 5, 5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


@pytest.fixture(scope='module')
def seg():
    """NHWC logits with argmax ties, targets with ignored pixels, weather
    ids that repeat and skip one weather, and a sample mask."""
    rng = np.random.default_rng(0)
    tied = rng.integers(0, 3, (B, H, W, C)).astype(np.float32)
    smooth = rng.standard_normal((B, H, W, C)).astype(np.float32)
    logits = np.where(rng.random((B, H, W, 1)) < 0.5, tied, smooth)
    targets = rng.integers(0, C, (B, H, W)).astype(np.int32)
    targets[:, :2, :3] = 255
    targets[1, 4] = C + 2                      # a label past the classes
    wids = np.array([0, 2, 2, 4, 1], np.int32)
    mask = np.array([True, True, False, True, True])
    return logits, targets, wids, mask


# ------------------------------------------------------------------- IoU

@pytest.mark.parametrize('lanes', [1, 7, iou.LANES])
def test_count_bins_over_lanes_equals_bincount(lanes):
    """Counts spread over copies of the bins (pixel i into copy i mod
    lanes) sum to the plain count; the value n counts nowhere."""
    rng = np.random.default_rng(8)
    idx = np.where(rng.random(20000) < 0.9, rng.integers(0, 3, 20000),
                   rng.integers(0, 41, 20000))       # a few hot bins
    got = iou.count_bins(_t(idx), 40, lanes)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(idx, minlength=41)[:40])


@pytest.mark.parametrize('use_mask', [False, True])
def test_confusion_matrices_match_jax(seg, use_mask):
    logits, targets, wids, mask = seg
    m = mask if use_mask else None
    got = iou.confusion_matrix_from_logits(_t(logits), _t(targets), C,
                                           sample_mask=None if m is None
                                           else _t(m))
    want = jiou.confusion_matrix_from_logits(_j(logits), _j(targets), C,
                                             sample_mask=None if m is None
                                             else _j(m))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = iou.confusion_matrix(_t(logits.transpose(0, 3, 1, 2)), _t(targets),
                               C, sample_mask=None if m is None else _t(m))
    want = jiou.confusion_matrix(_j(logits.transpose(0, 3, 1, 2)),
                                 _j(targets), C,
                                 sample_mask=None if m is None else _j(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('use_mask', [False, True])
def test_per_weather_confusion_matrices_match_jax_and_sum(seg, use_mask):
    logits, targets, wids, mask = seg
    m = mask if use_mask else None
    tm, jm = (None, None) if m is None else (_t(m), _j(m))
    got = iou.confusion_matrix_per_weather_from_logits(
        _t(logits), _t(targets), C, _t(wids), NW, sample_mask=tm)
    want = jiou.confusion_matrix_per_weather_from_logits(
        _j(logits), _j(targets), C, _j(wids), NW, sample_mask=jm)
    assert got.dtype == torch.int64 and got.shape == (NW, C, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    overall = iou.confusion_matrix_from_logits(_t(logits), _t(targets), C,
                                               sample_mask=tm)
    assert torch.equal(got.sum(0), overall)
    assert int(got[3].sum()) == 0                # no sample of weather 3
    kept = np.ones(B, bool) if m is None else m
    for w in range(NW):
        n = ((targets != 255) & (wids == w)[:, None, None]
             & kept[:, None, None]).sum()
        assert int(got[w].sum()) == n
    preds = logits.argmax(-1)
    preds[0, 0, 0] = C + 4                       # clipped, as JAX clips
    got = iou.confusion_matrix_per_weather(_t(preds), _t(targets), C,
                                           _t(wids), NW, sample_mask=tm)
    want = jiou.confusion_matrix_per_weather(_j(preds), _j(targets), C,
                                             _j(wids), NW, sample_mask=jm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pixel_accuracy_and_iou_from_confusion_match_jax(seg):
    logits, targets, _, _ = seg
    cm = iou.confusion_matrix_from_logits(_t(logits), _t(targets), C)
    jcm = jiou.confusion_matrix_from_logits(_j(logits), _j(targets), C)
    np.testing.assert_allclose(
        float(iou.pixel_accuracy_from_confusion(cm)),
        float(jiou.pixel_accuracy_from_confusion(jcm)), rtol=1e-6)
    assert float(iou.pixel_accuracy_from_confusion(torch.zeros(3, 3))) == 0.0
    np.testing.assert_allclose(float(iou.iou_from_confusion(cm)['mean_iou']),
                               float(jiou.iou_from_confusion(jcm)['mean_iou']),
                               rtol=1e-6)


def test_iou_metrics_facade_matches_jax(seg):
    logits, targets, _, _ = seg
    nchw = logits.transpose(0, 3, 1, 2)
    got = iou.IoUMetrics(C).compute_iou(nchw, targets)
    want = jiou.IoUMetrics(C).compute_iou(nchw, targets)
    np.testing.assert_allclose(got['mean_iou'], want['mean_iou'], rtol=1e-6)
    np.testing.assert_allclose(got['per_class_iou'], want['per_class_iou'],
                               rtol=1e-6)
    np.testing.assert_array_equal(got['valid_classes'], want['valid_classes'])
    for preds in (nchw, logits.argmax(-1)):
        np.testing.assert_allclose(
            iou.IoUMetrics(C).compute_pixel_accuracy(preds, targets),
            jiou.IoUMetrics(C).compute_pixel_accuracy(preds, targets),
            rtol=1e-6)


# ----------------------------------------------------------- calibration

def _assert_bins_equal(got, want):
    """Counts exactly, the f32 sums within 1e-6 relative."""
    got, want = got.numpy(), np.asarray(want, np.float64)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('layout', ['nchw', 'nhwc'])
@pytest.mark.parametrize('use_mask', [False, True])
def test_ece_bins_match_jax(seg, layout, use_mask):
    logits, targets, _, mask = seg
    x = logits.transpose(0, 3, 1, 2) if layout == 'nchw' else logits
    tm, jm = (_t(mask), _j(mask)) if use_mask else (None, None)
    got = calibration.ece_bin_update(_t(x), _t(targets), sample_mask=tm)
    want = jcal.ece_bin_update(_j(x), _j(targets), sample_mask=jm)
    _assert_bins_equal(got, want)
    kept = mask if use_mask else np.ones(B, bool)
    assert got[:, 0].sum() == ((targets != 255) & kept[:, None, None]).sum()
    for total in (None, 500.0):
        np.testing.assert_allclose(
            float(calibration.ece_from_bins(got, total)),
            float(jcal.ece_from_bins(want, total)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('use_mask', [False, True])
def test_ece_bins_per_weather_match_jax_and_sum(seg, use_mask):
    logits, targets, wids, mask = seg
    tm, jm = (_t(mask), _j(mask)) if use_mask else (None, None)
    got = calibration.ece_bin_update_per_weather(
        _t(logits), _t(targets), _t(wids), NW, sample_mask=tm)
    want = jcal.ece_bin_update_per_weather(
        _j(logits), _j(targets), _j(wids), NW, sample_mask=jm)
    assert got.shape == (NW, 15, 3)
    _assert_bins_equal(got, want)
    overall = calibration.ece_bin_update(_t(logits), _t(targets),
                                         sample_mask=tm, class_axis=-1)
    np.testing.assert_array_equal(got.sum(0)[:, 0].numpy(),
                                  overall[:, 0].numpy())
    np.testing.assert_allclose(got.sum(0).numpy(), overall.numpy(),
                               rtol=1e-6, atol=1e-6)
    for w in range(NW):
        np.testing.assert_allclose(float(calibration.ece_from_bins(got[w])),
                                   float(jcal.ece_from_bins(want[w])),
                                   rtol=1e-6, atol=1e-7)


def test_ece_bin_edges():
    """Bin b covers (b/nb, (b+1)/nb]: with 4 bins a confidence of exactly
    0.5 (two equal logits) joins bin 1, 0.25 (four) bin 0, 1.0 bin 3, in
    both frameworks."""
    logits = np.zeros((1, 3, 1, 4), np.float32)   # [B, H, W, C]
    logits[0, 0, 0, 2:] = -np.inf                 # two classes left: 0.5
    logits[0, 2, 0, 1] = 200.0                    # one class: 1.0
    targets = np.array([[[0], [1], [1]]], np.int32)
    got = calibration.ece_bin_update(_t(logits), _t(targets), num_bins=4,
                                     class_axis=-1)
    want = jcal.ece_bin_update(_j(logits), _j(targets), num_bins=4,
                               class_axis=-1)
    _assert_bins_equal(got, want)
    np.testing.assert_array_equal(got[:, 0].numpy(), [1, 1, 0, 1])
    np.testing.assert_array_equal(got[:, 1].numpy(), [0.25, 0.5, 0, 1.0])


def test_confidence_calibration_facade_matches_jax(seg):
    logits, targets, _, _ = seg
    nchw = logits.transpose(0, 3, 1, 2) * 2.0
    got = calibration.ConfidenceCalibration().compute_ece(
        nchw, targets, return_details=True)
    want = jcal.ConfidenceCalibration().compute_ece(nchw, targets,
                                                    return_details=True)
    np.testing.assert_allclose(got['ece'], want['ece'], rtol=1e-6, atol=1e-7)
    for k in ('overall_accuracy', 'overall_confidence'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    for g, w in zip(got['bin_details'], want['bin_details'], strict=True):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7)
    got = calibration.ConfidenceCalibration().compute_reliability_diagram_data(
        nchw, targets)
    want = jcal.ConfidenceCalibration().compute_reliability_diagram_data(
        nchw, targets)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        calibration.ConfidenceCalibration().compute_ece(nchw, targets),
        jcal.ConfidenceCalibration().compute_ece(nchw, targets), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(
        calibration.ConfidenceCalibration.temperature_scale(nchw, 2.5).numpy(),
        np.asarray(jcal.ConfidenceCalibration.temperature_scale(nchw, 2.5)),
        rtol=1e-7)


@pytest.mark.parametrize('scale', [0.3, 4.0])
def test_optimize_temperature_matches_jax(seg, scale):
    logits, targets, _, _ = seg
    targets = np.where(targets == C + 2, 0, targets)   # labels in range
    nchw = logits.transpose(0, 3, 1, 2) * scale
    got = calibration.ConfidenceCalibration().optimize_temperature(nchw,
                                                                   targets)
    want = jcal.ConfidenceCalibration().optimize_temperature(nchw, targets)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------- disagreement

@pytest.mark.parametrize('class_axis', [1, -1])
def test_disagreement_maps_match_jax(class_axis):
    rng = np.random.default_rng(1)
    shape = (2, C, 6, 7) if class_axis == 1 else (2, 6, 7, C)
    members = [rng.standard_normal(shape).astype(np.float32) * s
               for s in (1.0, 3.0, 0.5)]
    for k in (2, 3):
        got = disagreement.disagreement_map([_t(m) for m in members[:k]],
                                            class_axis)
        want = jdis.disagreement_map([_j(m) for m in members[:k]],
                                     class_axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        got = disagreement.variance_map([_t(m) for m in members[:k]],
                                        class_axis)
        want = jdis.variance_map([_j(m) for m in members[:k]], class_axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # the sweep's mean softmax, as JAX's evaluator forms it
    _, mean_probs = disagreement.disagreement_and_mean_probs(
        [_t(m) for m in members[:2]], class_axis)
    want = (jax.nn.softmax(_j(members[0]), axis=class_axis)
            + jax.nn.softmax(_j(members[1]), axis=class_axis)) / 2.0
    np.testing.assert_allclose(mean_probs.numpy(), np.asarray(want),
                               atol=1e-7)
    got = disagreement.jensen_shannon_divergence(_t(members[0]),
                                                 _t(members[1]), class_axis)
    want = jdis.jensen_shannon_divergence(_j(members[0]), _j(members[1]),
                                          class_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError, match='at least 2'):
        disagreement.disagreement_map([_t(members[0])])


def _scores_labels(n, seed, ties):
    rng = np.random.default_rng(seed)
    scores = rng.random(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 20) / 20          # many tie groups
    labels = (rng.random(n) < scores * 0.8).astype(np.float32)
    weights = (rng.random(n) < 0.85).astype(np.float32)
    return scores, labels, weights


@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('weighted', [False, True])
def test_auroc_exact_matches_jax(ties, weighted):
    s, lab, w = _scores_labels(3000, 2, ties)
    w = w if weighted else None
    got = disagreement.auroc_exact(_t(s), _t(lab),
                                   None if w is None else _t(w))
    want = jdis.auroc_exact(_j(s), _j(lab), None if w is None else _j(w))
    assert 0.55 < float(got) < 0.95
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def test_auroc_exact_brute_force_and_degenerate():
    s, lab, _ = _scores_labels(300, 3, ties=True)
    pos, neg = s[lab > 0], s[lab == 0]
    brute = ((pos[:, None] > neg[None]).sum()
             + 0.5 * (pos[:, None] == neg[None]).sum()) / (len(pos) * len(neg))
    np.testing.assert_allclose(float(disagreement.auroc_exact(_t(s),
                                                              _t(lab))),
                               brute, atol=1e-12)
    for labels in (np.zeros(300, np.float32), np.ones(300, np.float32)):
        assert float(disagreement.auroc_exact(_t(s), _t(labels))) == 0.5
        assert float(jdis.auroc_exact(_j(s), _j(labels))) == 0.5
    # every positive left out by the weights: degenerate too
    assert float(disagreement.auroc_exact(_t(s), _t(lab),
                                          _t(1.0 - lab))) == 0.5


def test_auroc_histogram_linear_matches_jax_bin_for_bin():
    s, lab, w = _scores_labels(5000, 4, ties=False)
    s = s * 0.9 - 0.05                              # some below lo
    got = disagreement.auroc_histogram_update(_t(s), _t(lab), 64, 0.0, 0.8,
                                              weights=_t(w))
    want = jdis.auroc_histogram_update(_j(s), _j(lab), 64, 0.0, 0.8,
                                       weights=_j(w))
    assert got.dtype == torch.int64 and got.shape == (64, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == int(w.sum())
    np.testing.assert_allclose(float(disagreement.auroc_from_histogram(got)),
                               float(jdis.auroc_from_histogram(want)),
                               atol=1e-6)


@pytest.mark.parametrize('num_bins', [1 << 10, 1 << 20])
def test_auroc_histogram_log_scale_matches_jax(num_bins):
    """Scores spread over decades above lo, as the mutual information of
    two members is; their AUROC from the histogram within 1e-6 of JAX's and
    within 1e-4 of the exact one at 2^20 bins."""
    rng = np.random.default_rng(5)
    s = (10.0 ** rng.uniform(-7, -0.2, 20000)).astype(np.float32) - 0.01
    lab = (rng.random(20000) < np.clip(np.log10(s + 0.02) + 2.2, 0, 1)
           ).astype(np.float32)
    w = (rng.random(20000) < 0.9).astype(np.float32)
    got = disagreement.auroc_histogram_update(_t(s), _t(lab), num_bins,
                                              -0.01, 0.75, weights=_t(w),
                                              log_scale=True)
    want = jdis.auroc_histogram_update(_j(s), _j(lab), num_bins, -0.01, 0.75,
                                       weights=_j(w), log_scale=True)
    np.testing.assert_array_equal(got.sum(0).numpy(),
                                  np.asarray(want).sum(0))
    moved = np.abs(got.numpy() - np.asarray(want)).sum() / 2
    assert moved <= 1e-3 * w.sum(), moved
    a_got = float(disagreement.auroc_from_histogram(got))
    np.testing.assert_allclose(a_got,
                               float(jdis.auroc_from_histogram(want)),
                               atol=1e-6)
    if num_bins == 1 << 20:
        exact = float(disagreement.auroc_exact(_t(s), _t(lab), _t(w)))
        assert abs(a_got - exact) < 1e-4


def test_auroc_from_histogram_degenerate():
    hist = torch.zeros(8, 2, dtype=torch.int64)
    hist[3, 0] = 5
    assert float(disagreement.auroc_from_histogram(hist)) == 0.5
    assert float(jdis.auroc_from_histogram(_j(hist.numpy()))) == 0.5


def test_ensemble_disagreement_facade_matches_jax(seg):
    logits, targets, _, _ = seg
    rng = np.random.default_rng(6)
    members = [logits.transpose(0, 3, 1, 2),
               rng.standard_normal((B, C, H, W)).astype(np.float32)]
    got = disagreement.EnsembleDisagreementMetrics()
    want = jdis.EnsembleDisagreementMetrics()
    np.testing.assert_allclose(got.compute_disagreement_auroc(members,
                                                              targets),
                               want.compute_disagreement_auroc(members,
                                                               targets),
                               atol=1e-6)
    np.testing.assert_allclose(got.compute_disagreement_map(members).numpy(),
                               np.asarray(want.compute_disagreement_map(
                                   members)), atol=1e-6)
    np.testing.assert_allclose(got.compute_variance_map(members).numpy(),
                               np.asarray(want.compute_variance_map(members)),
                               atol=1e-6)
    np.testing.assert_allclose(
        got.compute_jensen_shannon_divergence(*members).numpy(),
        np.asarray(want.compute_jensen_shannon_divergence(*members)),
        atol=1e-6)


# ------------------------------------------------------------ robustness

@pytest.mark.parametrize('clean,adverse', [(0.0, 0.3), (0.5, 0.6),
                                           (0.5, 0.2), (0.8, 0.0)])
def test_degradation_ratio_matches_jax(clean, adverse):
    assert (metrics.RobustnessMetrics.compute_robustness_degradation_ratio(
        clean, adverse)
        == jrob.RobustnessMetrics.compute_robustness_degradation_ratio(
            clean, adverse))


def test_robustness_facade_matches_jax(seg):
    logits, targets, _, _ = seg
    rng = np.random.default_rng(7)
    nchw = logits.transpose(0, 3, 1, 2)
    other = rng.standard_normal(nchw.shape).astype(np.float32)
    got_rm, want_rm = metrics.RobustnessMetrics(C), jrob.RobustnessMetrics(C)
    got = got_rm.compute_comprehensive_metrics(nchw, targets, [nchw, other],
                                               'fog')
    want = want_rm.compute_comprehensive_metrics(nchw, targets,
                                                 [nchw, other], 'fog')
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    per = {'clean': {'mean_iou': 0.6, 'expected_calibration_error': 0.1},
           'fog': {'mean_iou': 0.4, 'ensemble_disagreement_auroc': 0.7},
           'snow': {'mean_iou': 0.7}}
    assert got_rm.create_robustness_summary(per) == \
        want_rm.create_robustness_summary(per)
    preds = {'clean': nchw, 'rain': other, 'night': []}
    tgts = {'clean': targets, 'rain': targets, 'night': []}
    got = got_rm.compute_weather_specific_metrics(preds, tgts)
    want = want_rm.compute_weather_specific_metrics(preds, tgts)
    assert got.keys() == want.keys() == {'miou_clean', 'miou_rain'}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_metrics_package_exports_what_jax_exports():
    import awsegbench.metrics as jm
    assert sorted(metrics.__all__) == sorted(jm.__all__)
    for name in metrics.__all__:
        assert callable(getattr(metrics, name))
