"""Confusion matrices and IoU (counterpart of ``awsegbench/metrics/iou.py``).

The JAX package counted with a one-hot matmul in f32 because scatter-adds
serialise on a TPU. Here the counts are an ``index_add_`` over a flat
joint index (``target·C + pred``, with ``weather·C`` in front for the
per-weather matrices) in int64, which is exact at any sweep size (integer
atomics on the card); ignored pixels go to one extra bin that is dropped.
Nothing syncs with the host (``torch.bincount`` on a CUDA tensor reads its
largest index back first). Atomics on the few bins that most pixels fall
into serialise on the card, so each count is spread over ``LANES`` copies
(pixel i adds to copy i mod ``LANES``), which are summed after.
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import torch

LANES = 256     # copies of each count, against atomics on one address


def lane_index(idx: torch.Tensor, n: int, lanes: int = LANES) -> torch.Tensor:
    """``idx`` (values in [0, n]) moved to pixel i's copy of the ``n + 1``
    bins, copy i mod ``lanes`` of a [lanes, n + 1] layout."""
    lane = torch.arange(idx.numel(), device=idx.device) % lanes
    return lane * (n + 1) + idx


def _counts(rows: torch.Tensor, cols: torch.Tensor, valid: torch.Tensor,
            n_rows: int, n_cols: int) -> torch.Tensor:
    """[n_rows, n_cols] int64 counts of the valid (row, col) pairs."""
    n = n_rows * n_cols
    return count_bins(torch.where(valid, rows * n_cols + cols, n),
                      n).reshape(n_rows, n_cols)


def count_bins(idx: torch.Tensor, n: int, lanes: int = LANES
               ) -> torch.Tensor:
    """[n] int64 counts of the values of the int64 ``idx`` in [0, n]; the
    value n counts nowhere. ``lanes`` copies of the bins take the adds
    (1 for a histogram whose bins are many already)."""
    counts = torch.zeros(lanes * (n + 1), dtype=torch.int64,
                         device=idx.device)
    if lanes > 1:
        idx = lane_index(idx, n, lanes)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts.view(lanes, n + 1)[:, :n].sum(0)


def _flat_valid(targets: torch.Tensor, ignore_index: int,
                sample_mask: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Flat int64 targets, their validity (not ignored, and in a sample
    that ``sample_mask`` [B] keeps) and the pixels per sample."""
    tgts = targets.reshape(-1).long()
    per_sample = targets[0].numel() if targets.ndim > 1 else 1
    valid = tgts != ignore_index
    if sample_mask is not None:
        valid &= torch.as_tensor(sample_mask, device=tgts.device).bool() \
            .repeat_interleave(per_sample)
    return tgts, valid, per_sample


def confusion_matrix(predictions: torch.Tensor, targets: torch.Tensor,
                     num_classes: int, ignore_index: int = 255,
                     sample_mask: torch.Tensor | None = None) -> torch.Tensor:
    """[C, C] int64 counts (rows = target, cols = prediction). NCHW logits
    (one more dim than targets) are argmaxed over dim 1; ``sample_mask``
    ([B] bool) leaves out whole samples."""
    if predictions.ndim == targets.ndim + 1:
        predictions = predictions.argmax(dim=1)
    c = num_classes
    preds = predictions.reshape(-1).long().clamp(0, c - 1)
    tgts, valid, _ = _flat_valid(targets, ignore_index, sample_mask)
    return _counts(tgts.clamp(0, c - 1), preds, valid, c, c)


def confusion_matrix_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                                 num_classes: int, ignore_index: int = 255,
                                 sample_mask: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """[C, C] int64 counts straight from NHWC logits."""
    c = num_classes
    preds = logits.argmax(dim=-1).reshape(-1)
    tgts, valid, _ = _flat_valid(targets, ignore_index, sample_mask)
    return _counts(tgts.clamp(0, c - 1), preds, valid, c, c)


def _per_weather(preds, targets, num_classes, weather_ids, n_weathers,
                 ignore_index, sample_mask):
    c = num_classes
    tgts, valid, per_sample = _flat_valid(targets, ignore_index, sample_mask)
    wid = torch.as_tensor(weather_ids, device=tgts.device).long() \
        .repeat_interleave(per_sample)
    # a weather id outside [0, n_weathers) counts nowhere, as its one-hot
    # row is zero in the JAX matmul
    valid &= (wid >= 0) & (wid < n_weathers)
    joint = wid * c + tgts.clamp(0, c - 1)
    return _counts(joint, preds, valid, n_weathers * c, c).reshape(
        n_weathers, c, c)


def confusion_matrix_per_weather_from_logits(
        logits: torch.Tensor, targets: torch.Tensor, num_classes: int,
        weather_ids: torch.Tensor, n_weathers: int, ignore_index: int = 255,
        sample_mask: torch.Tensor | None = None) -> torch.Tensor:
    """[n_weathers, C, C] int64 counts straight from NHWC logits, one
    matrix per weather id of each sample ([B]); the overall matrix is the
    sum over the weather axis."""
    return _per_weather(logits.argmax(dim=-1).reshape(-1), targets,
                        num_classes, weather_ids, n_weathers, ignore_index,
                        sample_mask)


def confusion_matrix_per_weather(predictions: torch.Tensor,
                                 targets: torch.Tensor, num_classes: int,
                                 weather_ids: torch.Tensor, n_weathers: int,
                                 ignore_index: int = 255,
                                 sample_mask: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """[n_weathers, C, C] int64 counts from class predictions [B, H, W]."""
    preds = predictions.reshape(-1).long().clamp(0, num_classes - 1)
    return _per_weather(preds, targets, num_classes, weather_ids, n_weathers,
                        ignore_index, sample_mask)


def iou_from_confusion(cm: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-class IoU and the mean over classes with a nonzero union."""
    cm = cm.double()
    inter = cm.diagonal()
    union = cm.sum(0) + cm.sum(1) - inter
    valid = union > 0
    per_class = torch.where(valid, inter / union.clamp(min=1.0), 0.0)
    n_valid = valid.sum()
    mean = torch.where(n_valid > 0, per_class.sum() / n_valid.clamp(min=1),
                       0.0)
    return {'mean_iou': mean, 'per_class_iou': per_class,
            'valid_classes': valid}


def pixel_accuracy_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """The diagonal's share of the counts; 0 for an empty matrix."""
    cm = cm.double()
    total = cm.sum()
    return torch.where(total > 0, cm.trace() / total.clamp(min=1.0), 0.0)


class IoUMetrics:
    """The reference's facade: numpy arrays or tensors in, Python floats
    and numpy arrays out."""

    def __init__(self, num_classes: int, ignore_index: int = 255) -> None:
        self.num_classes = num_classes
        self.ignore_index = ignore_index

    def compute_iou(self, predictions, targets) -> dict[str, object]:
        cm = confusion_matrix(torch.as_tensor(predictions),
                              torch.as_tensor(targets), self.num_classes,
                              self.ignore_index)
        out = iou_from_confusion(cm)
        return {'mean_iou': float(out['mean_iou']),
                'per_class_iou': out['per_class_iou'].cpu().numpy(),
                'valid_classes': out['valid_classes'].cpu().numpy()}

    def compute_pixel_accuracy(self, predictions, targets) -> float:
        preds = torch.as_tensor(predictions)
        tgts = torch.as_tensor(targets)
        if preds.ndim == tgts.ndim + 1:
            preds = preds.argmax(dim=1)
        valid = tgts != self.ignore_index
        correct = int(((preds == tgts) & valid).sum())
        total = int(valid.sum())
        return correct / total if total > 0 else 0.0

