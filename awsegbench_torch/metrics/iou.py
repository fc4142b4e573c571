"""Confusion matrices and IoU (counterpart of ``awsegbench/metrics/iou.py``).

The JAX package counted with a one-hot matmul because scatter-adds
serialise on a TPU. Here the counts are an ``index_add_`` over the flat
index ``target·C + pred`` in int64, which is exact; ignored pixels go to
one extra bin that is dropped, so nothing syncs with the host.
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import torch


def _counts(tgts: torch.Tensor, preds: torch.Tensor, valid: torch.Tensor,
            num_classes: int) -> torch.Tensor:
    c = num_classes
    idx = torch.where(valid, tgts.clamp(0, c - 1) * c + preds, c * c)
    cm = torch.zeros(c * c + 1, dtype=torch.int64, device=idx.device)
    cm.index_add_(0, idx, torch.ones_like(idx))
    return cm[:c * c].reshape(c, c)


def confusion_matrix(predictions: torch.Tensor, targets: torch.Tensor,
                     num_classes: int, ignore_index: int = 255) -> torch.Tensor:
    """[C, C] int64 counts (rows = target, cols = prediction). NCHW logits
    (one more dim than targets) are argmaxed over dim 1."""
    if predictions.ndim == targets.ndim + 1:
        predictions = predictions.argmax(dim=1)
    preds = predictions.reshape(-1).long().clamp(0, num_classes - 1)
    tgts = targets.reshape(-1).long()
    return _counts(tgts, preds, tgts != ignore_index, num_classes)


def confusion_matrix_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                                 num_classes: int,
                                 ignore_index: int = 255) -> torch.Tensor:
    """[C, C] int64 counts straight from NHWC logits."""
    preds = logits.argmax(dim=-1).reshape(-1)
    tgts = targets.reshape(-1).long()
    return _counts(tgts, preds, tgts != ignore_index, num_classes)


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
