"""Mask2Former-Swin-L alone: the reference's Swin (``models/swin.py``)
under the reference's Mask2Former head (``models/mask2former.py``: the
``MSDeformAttnPixelDecoder`` given the Swin's widths, the
``MaskedTransformerDecoder``, the semantic inference), composed here by
import; the deformable attention's ``sampling_offsets.bias`` takes the
published grid on load, as in ``builders/mask2former.py``.

Departures from the published model, beyond those of its parts' own
docstrings: none. (The class head on the last decoder layer alone, as the
R50 reference: the intermediate class predictions do not reach the
semantic output.)"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..models.mask2former import (MaskedTransformerDecoder, MSDeformAttn,
                                  MSDeformAttnPixelDecoder)
from ..models.swin import SwinTransformer
from .mask2former import add_grid


class Mask2FormerSwin(nn.Module):
    """NHWC images → ``{'segmentation': [B, H, W, classes]}``."""

    def __init__(self, num_classes, embed_dim, depths, heads, window,
                 mlp_ratio):
        super().__init__()
        self.backbone = SwinTransformer(embed_dim, depths, heads, window,
                                        mlp_ratio)
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            in_channels=tuple(self.backbone.num_features))
        self.predictor = MaskedTransformerDecoder(num_classes)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        feats = self.backbone(x.permute(0, 3, 1, 2))
        mask_features, tokens, sizes = self.pixel_decoder(*feats)
        cls, masks = self.predictor(tokens, sizes, mask_features)
        probs = torch.softmax(cls, -1)[..., :-1]
        up = F.interpolate(masks, size=(h, w), mode='bilinear',
                           align_corners=False).sigmoid()
        seg = torch.einsum('bqc,bqhw->bchw', probs, up)
        return {'segmentation': seg.permute(0, 2, 3, 1)}


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    s = config['swin']
    model = Mask2FormerSwin(config['model']['num_classes'], s['embed_dim'],
                            s['depths'], s['heads'], s['window'],
                            s['mlp_ratio'])
    for mod in model.modules():
        if isinstance(mod, MSDeformAttn):
            mod.register_load_state_dict_pre_hook(add_grid)
    return model
