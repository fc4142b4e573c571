"""Mask2Former-Swin-L (the factory's ``mask2former_swin`` type): the Swin
backbone (K15 in every block), then Mask2Former-R50's head: the
deformable-attention pixel decoder (K11), the masked-attention decoder and
the semantic inference, one model's scores.

The head's parts, their spans and the published grid of the deformable
attention are those of the R50's adapter (``models/mask2former.py``),
imported; the Swin adds a span on each window attention."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..counts import swin as counts
from . import mask2former as m2f

OUTPUTS = ('segmentation',)
MEMBERS = ()


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    from awsegbench_torch.models.mask2former import (MSDeformAttn,
                                                     mask2former_swin)
    s = config['swin']
    with torch.device('meta'):
        model = mask2former_swin(
            config['model']['num_classes'], embed_dim=s['embed_dim'],
            depths=tuple(s['depths']), heads=tuple(s['heads']),
            window=s['window'], mlp_ratio=s['mlp_ratio'])
    for mod in model.modules():
        if isinstance(mod, MSDeformAttn):
            mod.register_load_state_dict_pre_hook(m2f.add_grid)
    return model


def sizes(model: torch.nn.Module) -> dict:
    bb, pd, dec = model.backbone, model.pixel_decoder, model.predictor
    first = [stage.blocks[0] for stage in bb.layers]
    attn = pd.transformer.layers[0].self_attn
    cross = dec.transformer_cross_attention_layers[0].multihead_attn
    return {
        'swin': {
            'embed_dim': bb.patch_embed.proj.out_channels,
            'depths': [len(stage.blocks) for stage in bb.layers],
            'heads': [b.attn.heads for b in first],
            'window': first[0].window,
            'mlp_ratio': (first[0].mlp.fc1.out_features
                          // first[0].mlp.fc1.in_features)},
        'pixel_decoder': {
            'conv_dim': pd.mask_features.in_channels,
            'mask_dim': pd.mask_features.out_channels,
            'norm_groups': pd.layer_1.norm.num_groups,
            'transformer_layers': len(pd.transformer.layers),
            'heads': attn.n_heads,
            'levels': attn.n_levels,
            'points': attn.n_points,
            'ffn_dim': pd.transformer.layers[0].linear1.out_features},
        'decoder': {
            'num_queries': dec.query_feat.num_embeddings,
            'hidden_dim': dec.query_feat.embedding_dim,
            'heads': cross.n_heads,
            'ffn_dim': dec.transformer_ffn_layers[0].linear1.out_features,
            'layers': len(dec.transformer_ffn_layers),
            'mask_mlp_layers': len(dec.mask_embed.layers)},
        'model': {'num_classes': dec.class_embed.out_features - 1}}


def forward_flops(config: Mapping[str, Any], height: int,
                  width: int) -> float:
    return counts.forward_flops(config, height, width)


def spans(model: torch.nn.Module) -> list[tuple]:
    from awsegbench_torch.models.swin import WindowAttention
    return m2f.spans(model) + [(m, 'forward', 'sweep.swin_attn')
                               for m in model.backbone.modules()
                               if isinstance(m, WindowAttention)]
