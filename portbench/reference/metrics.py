"""The sweep's accumulators for one batch in plain torch, from the
definitions the port's ``Evaluator.accumulate`` keeps (the JAX package's),
in the same f32 arithmetic so that their integer values agree exactly on
the same logits: per weather, the confusion matrix of the ensemble's
argmax; the ECE bins (count, Σ confidence, Σ accuracy) of its f32 softmax,
bin ``ceil(conf·bins) − 1``; for an ensemble, over all weathers the
(positive, negative) histogram of the members' mutual information
H(mean p) − mean H(p_i) (1e-8 inside the logs) on log-spaced bins of
``log(mi − lo + 1e-9)``, positives being the pixels where the argmax of the
members' mean softmax is wrong. Label 255 counts nowhere."""

from __future__ import annotations

import torch

IGNORE = 255


def accumulators(seg: torch.Tensor, labels: torch.Tensor,
                 weather_ids: torch.Tensor, num_classes: int,
                 n_weathers: int, num_bins: int, hist_bins: int,
                 hist_range: tuple[float, float],
                 members=()) -> dict[str, torch.Tensor]:
    """One batch's {cm [W, C, C] int64, ece [W, bins, 3] f64} from NHWC
    logits ``seg``, labels [B, H, W] and weather ids [B], and with the two
    ``members``' NHWC logits (an ensemble's) hist [hist_bins, 2] int64."""
    c = num_classes
    per = labels[0].numel()
    lab = labels.reshape(-1).long()
    wid = weather_ids.long().repeat_interleave(per)
    valid = (lab != IGNORE) & (wid >= 0) & (wid < n_weathers)
    lab_c = lab.clamp(0, c - 1)

    pred = seg.argmax(dim=-1).reshape(-1)
    cm = torch.bincount((wid * c * c + lab_c * c + pred)[valid],
                        minlength=n_weathers * c * c)

    conf, pred_p = torch.softmax(seg, dim=-1, dtype=torch.float32).max(dim=-1)
    conf, pred_p = conf.reshape(-1), pred_p.reshape(-1)
    bins = (torch.ceil(conf * num_bins).int() - 1).clamp(0, num_bins - 1)
    keep = valid & (conf > 0)
    joint = (wid * num_bins + bins.long())[keep]
    n = n_weathers * num_bins
    ece = torch.stack([
        torch.bincount(joint, minlength=n).double(),
        torch.zeros(n, dtype=torch.float64, device=seg.device).index_add_(
            0, joint, conf[keep].double()),
        torch.bincount(joint, weights=(pred_p == lab)[keep].double(),
                       minlength=n)], dim=1)
    out = {'cm': cm.reshape(n_weathers, c, c),
           'ece': ece.reshape(n_weathers, num_bins, 3)}
    if not members:
        return out

    probs = torch.stack([torch.softmax(s, dim=-1, dtype=torch.float32)
                         for s in members])
    mean = probs.mean(dim=0)
    mean_entropy = -(mean * torch.log(mean + 1e-8)).sum(dim=-1)
    member_entropy = -(probs * torch.log(probs + 1e-8)).sum(dim=-1)
    mi = (mean_entropy - member_entropy.mean(dim=0)).float().reshape(-1)
    wrong = (mean.argmax(dim=-1) != labels).reshape(-1)
    lo, hi = hist_range
    eps = 1e-9

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=seg.device)
    s = torch.log(torch.clamp(mi - lo, min=0.0) + eps)
    t = (s - torch.log(f32(eps))) / (torch.log(f32(hi - lo + eps))
                                     - torch.log(f32(eps)))
    idx = (torch.clamp(t, 0.0, 1.0 - 1e-7) * hist_bins).long()
    live = lab != IGNORE
    hist = torch.bincount((2 * idx + (~wrong).long())[live],
                          minlength=2 * hist_bins).reshape(hist_bins, 2)
    return out | {'hist': hist}
