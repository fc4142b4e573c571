"""Ensemble disagreement: maps and the AUROC of disagreement against
errors (counterpart of ``awsegbench/metrics/disagreement.py``).

The reference's quirks are kept, as the JAX package keeps them:

* the "JS divergence" is ½[KL(m‖p1) + KL(m‖p2)], torch ``F.kl_div(p.log(),
  m)``'s reversed arguments;
* the disagreement map adds 1e-8 inside its logs;
* a degenerate AUROC (the labels all one class) is 0.5;
* the variance map is the unbiased variance.

The exact AUROC is the midrank Mann-Whitney U (what sklearn's trapezoid
ROC integrates to), on the scores sorted once; the streaming estimate
counts positives and negatives per score bin. Both count in int64 or f64
where the JAX package summed in f32, so they stay exact past 2^24 pixels.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.mesh import DataMesh
from ..parallel.collectives import all_gather_varlen
from .iou import count_bins


def _probs(logits_list, class_axis):
    """The members' f32 softmaxes, stacked on a leading axis."""
    return torch.stack([torch.softmax(lg, dim=class_axis, dtype=torch.float32)
                        for lg in logits_list])


def disagreement_and_mean_probs(logits_list: Sequence[torch.Tensor],
                                class_axis: int = 1
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`disagreement_map` and the members' mean softmax it is
    computed from (the sweep takes the ensemble's errors from it)."""
    if len(logits_list) < 2:
        raise ValueError('Need at least 2 predictions for disagreement '
                         'computation')
    probs = _probs(logits_list, class_axis)
    mean_probs = probs.mean(dim=0)
    mean_entropy = -(mean_probs * torch.log(mean_probs + 1e-8)).sum(
        dim=class_axis)
    # the stack adds a leading member axis
    stacked_axis = class_axis if class_axis < 0 else class_axis + 1
    member_entropy = -(probs * torch.log(probs + 1e-8)).sum(dim=stacked_axis)
    return mean_entropy - member_entropy.mean(dim=0), mean_probs


def disagreement_map(logits_list: Sequence[torch.Tensor],
                     class_axis: int = 1) -> torch.Tensor:
    """Mutual information of the members' softmaxes: H(mean p) − mean_i
    H(p_i), with 1e-8 inside the logs."""
    return disagreement_and_mean_probs(logits_list, class_axis)[0]


def variance_map(logits_list: Sequence[torch.Tensor],
                 class_axis: int = 1) -> torch.Tensor:
    """Unbiased variance of the softmax probabilities across members."""
    return _probs(logits_list, class_axis).var(dim=0, correction=1)


def jensen_shannon_divergence(logits1: torch.Tensor, logits2: torch.Tensor,
                              class_axis: int = 1) -> torch.Tensor:
    """The reference's "JS divergence", ½[KL(m‖p1) + KL(m‖p2)] with m the
    mean of the two softmaxes, summed over the class axis."""
    p1 = torch.softmax(logits1, dim=class_axis, dtype=torch.float32)
    p2 = torch.softmax(logits2, dim=class_axis, dtype=torch.float32)
    m = (p1 + p2) / 2.0
    kl1 = (m * (torch.log(m) - torch.log(p1))).sum(dim=class_axis)
    kl2 = (m * (torch.log(m) - torch.log(p2))).sum(dim=class_axis)
    return (kl1 + kl2) / 2.0


def auroc_exact(scores: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """Exact AUROC of ``scores`` [N] (higher: more likely positive) for
    ``labels`` [N] in {0, 1}, over the entries ``weights`` (a 0/1 mask)
    keeps: midrank Mann-Whitney U, as sklearn's ``roc_auc_score``; 0.5
    when the kept labels are all one class. A float64 scalar.

    One stable sort of the scores; each run of equal scores (a tie group)
    gives its kept members the mean of the ranks they share, from a
    cumulative count in f64 (exact up to 2^53 entries)."""
    scores = scores.float().reshape(-1)
    labels = labels.double().reshape(-1)
    w = torch.ones_like(labels) if weights is None \
        else weights.double().reshape(-1)
    labels = labels * w
    s_sorted, order = torch.sort(scores, stable=True)
    l_sorted, w_sorted = labels[order], w[order]
    ranks = torch.cumsum(w_sorted, 0)            # rank among kept entries
    _, counts = torch.unique_consecutive(s_sorted, return_counts=True)
    ends = torch.cumsum(counts, 0) - 1
    before = (ranks - w_sorted)[ends - counts + 1]   # kept ranks below
    group_w = ranks[ends] - before
    midrank = torch.where(group_w > 0, before + (group_w + 1.0) / 2.0, 0.0)
    n_pos = l_sorted.sum()
    n_neg = w_sorted.sum() - n_pos
    u = (midrank.repeat_interleave(counts) * l_sorted).sum() \
        - n_pos * (n_pos + 1.0) / 2.0
    auroc = u / (n_pos * n_neg).clamp(min=1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auroc, 0.5)


def auroc_exact_sharded(scores: torch.Tensor, labels: torch.Tensor,
                        weights: torch.Tensor | None,
                        mesh: DataMesh | None) -> torch.Tensor:
    """Exact AUROC over every rank's buffer: :func:`auroc_exact` of the
    ranks' ``scores``, ``labels`` and ``weights`` (a 0/1 mask) concatenated
    in rank order, the same value on every rank. Torch has no distributed
    sort, so each rank gathers every buffer (the scores in f32, a label or
    −1 for a dropped entry in int8: 5 bytes a pixel) and sorts the whole;
    the JAX package sorts a sharded buffer in place."""
    if mesh is None or mesh.size <= 1:
        return auroc_exact(scores, labels, weights)
    keep = (torch.ones_like(labels, dtype=torch.bool) if weights is None
            else weights.reshape(labels.shape) > 0)
    code = torch.where(keep, labels.to(torch.int8), -1).reshape(-1)
    scores = all_gather_varlen(scores.float().reshape(-1), mesh)
    code = all_gather_varlen(code, mesh)
    return auroc_exact(scores, code.clamp(min=0), code >= 0)


def auroc_histogram_update(scores: torch.Tensor, labels: torch.Tensor,
                           num_bins: int, lo: float, hi: float,
                           weights: torch.Tensor | None = None,
                           log_scale: bool = False) -> torch.Tensor:
    """Streaming AUROC counts: [num_bins, 2] int64 (positives, negatives)
    per score bin over [lo, hi); add them across batches and read them with
    :func:`auroc_from_histogram`. ``labels`` are in {0, 1} and ``weights``
    is a 0/1 mask, as the sweep passes them. ``log_scale`` bins
    log(score − lo + 1e-9) instead: AUROC does not change under a monotone
    map, and log bins keep their resolution where the scores crowd the low
    end (mutual information of members that nearly agree). The bin index
    is computed in f32 as the JAX package computes it; a score on a bin
    edge may still land one bin over where the two frameworks' ``log``
    differ in the last place."""
    scores = scores.float().reshape(-1)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=scores.device)

    if log_scale:
        eps = 1e-9
        s = torch.log(torch.clamp(scores - lo, min=0.0) + eps)
        s_lo, s_hi = torch.log(f32(eps)), torch.log(f32(hi - lo + eps))
        t = (s - s_lo) / (s_hi - s_lo)
    else:
        t = (scores - lo) / f32(max(hi - lo, 1e-12))
    idx = (torch.clamp(t, 0.0, 1.0 - 1e-7) * num_bins).long()
    neg = (labels.reshape(-1) == 0).long()        # column 1 counts negatives
    keep = torch.ones_like(neg, dtype=torch.bool) if weights is None \
        else weights.reshape(-1) != 0
    return count_bins(torch.where(keep, 2 * idx + neg, 2 * num_bins),
                      2 * num_bins, lanes=1).reshape(num_bins, 2)


def auroc_from_histogram(hist: torch.Tensor) -> torch.Tensor:
    """AUROC from (positive, negative) counts per score bin, in float64,
    with the within-bin ties counted half; 0.5 when either count is 0."""
    hist = torch.as_tensor(hist).double()
    pos, neg = hist[:, 0], hist[:, 1]
    n_pos, n_neg = pos.sum(), neg.sum()
    neg_below = torch.cumsum(neg, 0) - neg
    u = (pos * (neg_below + 0.5 * neg)).sum()
    auroc = u / (n_pos * n_neg).clamp(min=1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auroc, 0.5)


class EnsembleDisagreementMetrics:
    """The reference's facade, on NCHW logits (class axis 1)."""

    def compute_disagreement_map(self, predictions_list) -> torch.Tensor:
        return disagreement_map([torch.as_tensor(p) for p in predictions_list])

    def compute_variance_map(self, predictions_list) -> torch.Tensor:
        return variance_map([torch.as_tensor(p) for p in predictions_list])

    def compute_disagreement_auroc(self, predictions_list, targets,
                                   error_threshold: float = 0.5) -> float:
        """AUROC of the disagreement map against the errors of the argmax
        of the members' mean softmax, over the non-ignored pixels.
        ``error_threshold`` is the reference's and unused."""
        tgts = torch.as_tensor(targets)
        dis, mean_probs = disagreement_and_mean_probs(
            [torch.as_tensor(p) for p in predictions_list])
        errors = mean_probs.argmax(dim=1) != tgts
        return float(auroc_exact(dis.reshape(-1), errors.reshape(-1),
                                 weights=(tgts != 255).reshape(-1)))

    def compute_jensen_shannon_divergence(self, pred1, pred2) -> torch.Tensor:
        return jensen_shannon_divergence(torch.as_tensor(pred1),
                                         torch.as_tensor(pred2))
