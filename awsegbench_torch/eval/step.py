"""The benchmark's eval step (counterpart of ``bench.py``'s ``eval_step``).

uint8 batch → ``prepare_batch`` (mixed-weather corruption + ImageNet
normalisation) → ensemble forward in the working dtype →
``cm += confusion_matrix_from_logits(...)`` and ``dsum += depth.sum()``.
Everything stays on the device; nothing syncs with the host.
"""

from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from ..data.pipeline import prepare_batch
from ..metrics.iou import confusion_matrix_from_logits


class EvalStep:
    """Accumulates a confusion matrix ``cm`` [C, C] (int64) and the sum of
    the ensemble depth ``dsum`` (float32) over the batches it is called on.
    Puts ``model`` on ``device`` in ``dtype`` and in eval mode."""

    def __init__(self, model: nn.Module, num_classes: int = 19,
                 device: str | torch.device = 'cuda',
                 dtype: torch.dtype = torch.bfloat16) -> None:
        self.device = resolve_device(device)
        self.dtype = dtype
        self.num_classes = num_classes
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.cm = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                              device=self.device)
        self.dsum = torch.zeros((), dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def __call__(self, images_u8: torch.Tensor, labels: torch.Tensor,
                 weather_ids: torch.Tensor,
                 generator: torch.Generator | None = None,
                 draws: dict[str, torch.Tensor] | None = None
                 ) -> dict[str, torch.Tensor]:
        """One batch: images [B, H, W, 3] uint8, labels [B, H, W], weather
        ids [B]; corruption draws from ``generator`` (on the device) or
        given as ``draws``. Returns the model's outputs."""
        dev = self.device
        images_u8, labels = images_u8.to(dev), labels.to(dev)
        weather_ids = weather_ids.to(dev)
        # The JAX step asks prepare_batch for the depth target but never
        # reads it, so XLA drops that work. Eager PyTorch would run it, so
        # it is not asked for here: both programs do the same work.
        prep = prepare_batch(images_u8, labels, weather_ids,
                             generator=generator, draws=draws,
                             include_depth=False)
        out = self.model(prep['image'].to(self.dtype))
        self.cm += confusion_matrix_from_logits(out['segmentation'], labels,
                                                self.num_classes)
        self.dsum += out['depth'].float().sum()
        return out
