"""Confidence calibration: streaming ECE bins (counterpart of
``awsegbench/metrics/calibration.py``).

Per bin, a batch gives (count, sum of confidence, sum of accuracy), and
ECE = Σ_b |conf̄_b − acc̄_b|·(n_b/N) is computed from the sums, which
equals the reference's two-pass formula. Bin b covers ``(b/nb, (b+1)/nb]``, so
its index is ``ceil(conf·nb) − 1``; a confidence of exactly 0 joins no bin.

The JAX package counted with an f32 one-hot matmul, whose counts are exact
only up to 2^24 per bin. Here the counts are an int64 count over the joint
index (``weather·nb + bin``), exact at any size; the confidence and
accuracy sums are f32 within a batch, as JAX sums them, added into f64
across batches. The batch statistics come back as one float64 [..., 3]
tensor whose count column holds those int64 counts (exact below 2^53).
On the card the f32 sums are ``index_add_`` atomics, spread over
``iou.LANES`` copies of the bins as the counts are, which add in no fixed
order: they are not bit-reproducible from run to run.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .iou import LANES, count_bins, lane_index


def _bin_stats(logits, targets, num_bins, ignore_index, sample_mask,
               class_axis, weather_ids=None, n_weathers=1):
    """[n_weathers · num_bins, 3] float64 (count, Σ confidence, Σ accuracy)
    over the joint index ``weather·num_bins + bin``."""
    # max returns the first maximum's index, as argmax does
    conf, pred = torch.softmax(logits, dim=class_axis,
                               dtype=torch.float32).max(dim=class_axis)
    conf, pred = conf.reshape(-1), pred.reshape(-1)
    tgt = targets.reshape(-1).long()
    per_sample = targets[0].numel()
    valid = tgt != ignore_index
    if sample_mask is not None:
        valid &= torch.as_tensor(sample_mask, device=tgt.device).bool() \
            .repeat_interleave(per_sample)
    acc = (pred == tgt).float()
    bins = (torch.ceil(conf * num_bins).int() - 1).clamp(0, num_bins - 1)
    keep = (conf > 0) & valid
    if weather_ids is not None:
        wid = torch.as_tensor(weather_ids, device=tgt.device).long() \
            .repeat_interleave(per_sample)
        keep &= (wid >= 0) & (wid < n_weathers)
        bins = wid * num_bins + bins
    n = n_weathers * num_bins
    idx = torch.where(keep, bins.long(), n)
    sums = torch.zeros((LANES * (n + 1), 2), dtype=torch.float32,
                       device=tgt.device)
    sums.index_add_(0, lane_index(idx, n), torch.stack([conf, acc], dim=1))
    sums = sums.view(LANES, n + 1, 2)[:, :n].sum(0)
    return torch.cat([count_bins(idx, n)[:, None].double(), sums.double()],
                     dim=1)


def ece_bin_update(logits: torch.Tensor, targets: torch.Tensor,
                   num_bins: int = 15, ignore_index: int = 255,
                   sample_mask: torch.Tensor | None = None,
                   class_axis: int | None = None) -> torch.Tensor:
    """Per-batch ECE bin statistics, [num_bins, 3] float64: (count, sum of
    confidence, sum of accuracy). ``logits`` is [B, C, H, W] (class axis
    1, the reference's layout) or [B, H, W, C]; unless ``class_axis`` is
    given, the class axis is 1 unless axis 1 matches the targets' H."""
    if class_axis is None:
        class_axis = -1 if logits.shape[1] == targets.shape[1] else 1
    return _bin_stats(logits, targets, num_bins, ignore_index, sample_mask,
                      class_axis)


def ece_from_bins(stats: torch.Tensor,
                  total_valid: torch.Tensor | float | None = None
                  ) -> torch.Tensor:
    """ECE from accumulated bin statistics, in float64. ``total_valid``
    (the count of valid pixels, the proportion's denominator as the
    reference's ``in_bin.float().mean()``) defaults to the sum of the bin
    counts, which is right whenever no confidence is exactly 0."""
    stats = torch.as_tensor(stats).double()
    counts = stats[:, 0]
    if total_valid is None:
        total_valid = counts.sum()
    total_valid = torch.as_tensor(total_valid, dtype=torch.float64,
                                  device=stats.device)
    n = counts.clamp(min=1.0)
    conf_mean = torch.where(counts > 0, stats[:, 1] / n, 0.0)
    acc_mean = torch.where(counts > 0, stats[:, 2] / n, 0.0)
    prop = counts / total_valid.clamp(min=1.0)
    return ((conf_mean - acc_mean).abs() * prop).sum()


def ece_bin_update_per_weather(logits: torch.Tensor, targets: torch.Tensor,
                               weather_ids: torch.Tensor, n_weathers: int,
                               num_bins: int = 15, ignore_index: int = 255,
                               sample_mask: torch.Tensor | None = None,
                               class_axis: int = -1) -> torch.Tensor:
    """[n_weathers, num_bins, 3] float64 ECE statistics, one set per
    weather id of each sample ([B]); the overall statistics are the sum
    over the weather axis."""
    return _bin_stats(logits, targets, num_bins, ignore_index, sample_mask,
                      class_axis, weather_ids, n_weathers).reshape(
                          n_weathers, num_bins, 3)


class ConfidenceCalibration:
    """The reference's facade: numpy arrays or tensors in, Python floats
    and numpy arrays out."""

    def __init__(self, num_bins: int = 15) -> None:
        self.num_bins = num_bins

    def compute_ece(self, predictions, targets,
                    return_details: bool = False) -> float | dict[str, Any]:
        stats = ece_bin_update(torch.as_tensor(predictions),
                               torch.as_tensor(targets), self.num_bins)
        ece = float(ece_from_bins(stats))
        if not return_details:
            return ece
        stats = stats.cpu().numpy()
        total = max(stats[:, 0].sum(), 1.0)
        edges = np.linspace(0, 1, self.num_bins + 1)
        bin_details = []
        for b, (cnt, csum, asum) in enumerate(stats):
            acc_b = asum / cnt if cnt > 0 else 0.0
            conf_b = csum / cnt if cnt > 0 else 0.0
            bin_details.append({
                'bin_lower': float(edges[b]), 'bin_upper': float(edges[b + 1]),
                'accuracy': float(acc_b), 'confidence': float(conf_b),
                'proportion': float(cnt / total),
                'error': float(abs(conf_b - acc_b))})
        return {'ece': ece, 'bin_details': bin_details,
                'overall_accuracy': float(stats[:, 2].sum() / total),
                'overall_confidence': float(stats[:, 1].sum() / total)}

    def compute_reliability_diagram_data(self, predictions,
                                         targets) -> dict[str, np.ndarray]:
        data = self.compute_ece(predictions, targets, return_details=True)
        kept = [b for b in data['bin_details'] if b['proportion'] > 0]
        return {
            'bin_centers': np.array([(b['bin_lower'] + b['bin_upper']) / 2
                                     for b in kept]),
            'bin_accuracies': np.array([b['accuracy'] for b in kept]),
            'bin_confidences': np.array([b['confidence'] for b in kept]),
            'bin_proportions': np.array([b['proportion'] for b in kept])}

    @staticmethod
    def temperature_scale(logits, temperature: float) -> torch.Tensor:
        return torch.as_tensor(logits) / temperature

    def optimize_temperature(self, logits, targets,
                             max_iter: int = 50) -> float:
        """The temperature among 100 in [0.1, 10] (f32 ``linspace``) with
        the least NLL over the non-ignored pixels; the first minimum, as
        the reference's strict '<' update keeps it. ``max_iter`` is the
        reference's and unused. As the JAX package, and unlike the
        reference's raw ``view(-1, C)`` of NCHW logits, the class axis is
        moved last before the flatten, so each row is a class
        distribution."""
        logits = torch.as_tensor(logits).float()
        tgts = torch.as_tensor(targets, device=logits.device).reshape(-1)
        lf = logits.movedim(1, -1).reshape(-1, logits.shape[1])
        valid = tgts != 255
        ll_idx = torch.where(valid, tgts, 0).long()[:, None]
        n_valid = valid.sum().clamp(min=1)
        temps = torch.linspace(0.1, 10.0, 100, dtype=torch.float32)
        nlls = torch.stack([
            -torch.where(valid, torch.log_softmax(lf / t, dim=-1)
                         .gather(1, ll_idx)[:, 0], 0.0).sum() / n_valid
            for t in temps.to(logits.device)])
        return float(temps[int(nlls.argmin())])
