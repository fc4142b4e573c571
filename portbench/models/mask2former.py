"""Mask2Former-R50 (the factory's ``mask2former`` type): the ResNet-50 at
output stride 32, the deformable-attention pixel decoder (K11), the
masked-attention decoder and the semantic inference, one model's scores.

Its deformable attention starts from the published grid: ``skeleton``
registers a load pre-hook on each ``MSDeformAttn`` that adds the port's
grid (``MSDeformAttn.grid``) to the drawn ``sampling_offsets.bias``, as
``reference/builders/mask2former.py`` adds its own."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..counts import mask2former as counts

OUTPUTS = ('segmentation',)
MEMBERS = ()


def add_grid(module, state_dict, prefix, *args) -> None:
    """A load pre-hook: the state's ``sampling_offsets.bias`` plus the
    module's grid (a new tensor; the caller's is left as it is)."""
    key = prefix + 'sampling_offsets.bias'
    if key in state_dict:
        v = state_dict[key]
        state_dict[key] = v + module.grid().to(device=v.device, dtype=v.dtype)


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    from awsegbench_torch.models.mask2former import (Mask2FormerModel,
                                                     MSDeformAttn)
    with torch.device('meta'):
        model = Mask2FormerModel(config['model']['num_classes'])
    for mod in model.modules():
        if isinstance(mod, MSDeformAttn):
            mod.register_load_state_dict_pre_hook(add_grid)
    return model


def sizes(model: torch.nn.Module) -> dict:
    bb, pd, dec = model.backbone, model.pixel_decoder, model.predictor
    firsts, i = [], 0
    for n in bb.stages:
        firsts.append(getattr(bb, f'Bottleneck_{i}'))
        i += n
    stride = bb.Conv_0.stride[0] * 2               # the stem and its pool
    for b in firsts:
        stride *= b.ConvBNReLU_1.Conv_0.stride[0]
    layer = pd.transformer.layers[0]
    attn = layer.self_attn
    cross = dec.transformer_cross_attention_layers[0].multihead_attn
    return {
        'backbone': {
            'encoder': f'resnet{3 * sum(bb.stages) + 2}',
            'layers': list(bb.stages),
            'widths': [b.ConvBNReLU_0.Conv_0.out_channels for b in firsts],
            'output_stride': stride},
        'pixel_decoder': {
            'conv_dim': pd.mask_features.in_channels,
            'mask_dim': pd.mask_features.out_channels,
            'norm_groups': pd.layer_1.norm.num_groups,
            'transformer_layers': len(pd.transformer.layers),
            'heads': attn.n_heads,
            'levels': attn.n_levels,
            'points': attn.n_points,
            'ffn_dim': layer.linear1.out_features},
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
    from awsegbench_torch.models.mask2former import MSDeformAttn
    dec = model.predictor
    return ([(model.backbone, 'forward', 'sweep.m2f_backbone'),
             (model.pixel_decoder, 'forward', 'sweep.m2f_pixel_decoder')]
            + [(m, 'forward', 'sweep.m2f_deform')
               for m in model.pixel_decoder.modules()
               if isinstance(m, MSDeformAttn)]
            + [(dec, 'forward', 'sweep.m2f_decoder')]
            + [(m, 'forward', 'sweep.m2f_masked_attn')
               for m in dec.transformer_cross_attention_layers]
            + [(model, 'semantic_inference', 'sweep.m2f_semseg')])
