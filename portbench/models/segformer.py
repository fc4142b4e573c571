"""SegFormer alone (the factory's ``segformer`` type): a MiT encoder and the
seg and depth heads, one model's logits."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..counts import flops

OUTPUTS = ('segmentation',)
MEMBERS = ()


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    from awsegbench_torch.models.segformer import (SegFormerModel,
                                                   mit_variant_config)
    m = config['model']
    hidden_sizes, depths = mit_variant_config(m['segformer_variant'])
    with torch.device('meta'):
        return SegFormerModel(m['num_classes'], m['include_depth'],
                              m['head_mode'], hidden_sizes, depths)


def section(sf: torch.nn.Module) -> dict:
    """The ``segformer`` size section of a built SegFormer."""
    enc = sf.MiTEncoder_0
    embeds = [getattr(enc, f'OverlapPatchEmbed_{i}').Conv_0 for i in range(4)]
    hidden = [c.out_channels for c in embeds]
    blocks = [b for n, b in enc.named_children()
              if n.startswith('SegFormerBlock_')]
    stages = [[b for b in blocks if b.LayerNorm_0.normalized_shape[0] == c]
              for c in hidden]

    def per_stage(get):
        values = [{get(b) for b in s} for s in stages]
        if any(len(v) != 1 for v in values):
            raise ValueError('a stage whose blocks differ')
        return [v.pop() for v in values]
    return {
        'hidden_sizes': hidden,
        'depths': [len(s) for s in stages],
        'num_heads': per_stage(lambda b: b.EfficientSelfAttention_0.num_heads),
        'sr_ratios': per_stage(lambda b: b.EfficientSelfAttention_0.sr_ratio),
        'mlp_ratios': per_stage(lambda b: b.MixFFN_0.Dense_0.out_features
                                // b.LayerNorm_0.normalized_shape[0]),
        'patch_sizes': [c.kernel_size[0] for c in embeds],
        'strides': [c.stride[0] for c in embeds],
        'layer_norm_eps': enc.LayerNorm_0.eps,
        'seg_head_hidden': sf.SegmentationHead_0.Conv_0.out_channels,
        'depth_head_hidden': sf.DepthEstimationHead_0.Conv_0.out_channels,
    }


def sizes(model: torch.nn.Module) -> dict:
    return {'segformer': section(model),
            'model': {'num_classes': model.SegmentationHead_0.Conv_1
                      .out_channels}}


def forward_flops(config: Mapping[str, Any], height: int,
                  width: int) -> float:
    m, sf = config['model'], config['segformer']
    return (flops.mit(height, width, sf)
            + flops.segformer_heads(height, width, sf, m['num_classes'],
                                    m['include_depth']))


def spans(model: torch.nn.Module) -> list[tuple]:
    return [(model, 'forward', 'sweep.segformer')]
