"""The SegFormer + DeepLabV3+ ensemble of the plain reference: a frozen
copy of ``awsegbench_torch/models/ensemble.py``. Softmaxed learnable
member weights, a learnable temperature dividing the mixed logits.
"""

from __future__ import annotations

import torch
from torch import nn

from .deeplab import DeepLabV3PlusModel
from .segformer import SegFormerModel, mit_variant_config


class EnsembleModel(nn.Module):
    def __init__(self, num_classes: int = 19, include_depth: bool = True,
                 ensemble_strategy: str = 'weighted_average',
                 temperature_scaling: bool = True,
                 head_mode: str = 'faithful',
                 segformer_variant: str = 'b0') -> None:
        super().__init__()
        if ensemble_strategy not in ('weighted_average', 'max_confidence',
                                     'average'):
            raise ValueError(f'unknown ensemble_strategy {ensemble_strategy!r}')
        hidden_sizes, depths = mit_variant_config(segformer_variant)
        self.include_depth = include_depth
        self.ensemble_strategy = ensemble_strategy
        self.temperature_scaling = temperature_scaling
        self.segformer = SegFormerModel(num_classes, include_depth, head_mode,
                                        hidden_sizes, depths)
        self.deeplabv3plus = DeepLabV3PlusModel(num_classes, include_depth)
        self.ensemble_weights = nn.Parameter(torch.full((2,), 0.5))
        if temperature_scaling:
            self.temperature = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor, seed: torch.Tensor | None = None,
                aspp_mask: torch.Tensor | None = None,
                segformer_depth_seed: torch.Tensor | None = None,
                deeplab_depth_seed: torch.Tensor | None = None
                ) -> dict[str, torch.Tensor]:
        """x [B, H, W, 3] normalized → NHWC outputs: 'segmentation',
        'segformer_seg', 'deeplabv3plus_seg' and, with depth, 'depth',
        'segformer_depth', 'deeplabv3plus_depth'. Train mode needs the seg
        head's dropout ``seed``, ASPP's ``aspp_mask`` and one int32 seed
        per depth head."""
        seg_out = self.segformer(x, seed, segformer_depth_seed)
        dlv_out = self.deeplabv3plus(x, aspp_mask, deeplab_depth_seed)
        s1, s2 = seg_out['segmentation'], dlv_out['segmentation']

        if self.ensemble_strategy == 'weighted_average':
            wts = torch.softmax(self.ensemble_weights.to(s1.dtype), dim=0)
            seg = wts[0] * s1 + wts[1] * s2
        elif self.ensemble_strategy == 'max_confidence':
            c1 = torch.softmax(s1, dim=-1).amax(dim=-1, keepdim=True)
            c2 = torch.softmax(s2, dim=-1).amax(dim=-1, keepdim=True)
            use_segformer = (c1 > c2).to(s1.dtype)
            seg = use_segformer * s1 + (1.0 - use_segformer) * s2
        else:
            seg = (s1 + s2) / 2.0
        if self.temperature_scaling:
            seg = seg / self.temperature.to(seg.dtype)

        out = {'segmentation': seg, 'segformer_seg': s1,
               'deeplabv3plus_seg': s2}
        if self.include_depth:
            d1, d2 = seg_out['depth'], dlv_out['depth']
            if self.ensemble_strategy == 'weighted_average':
                wts = torch.softmax(self.ensemble_weights.to(d1.dtype), dim=0)
                depth = wts[0] * d1 + wts[1] * d2
            else:
                depth = (d1 + d2) / 2.0
            out.update(depth=depth, segformer_depth=d1,
                       deeplabv3plus_depth=d2)
        return out
