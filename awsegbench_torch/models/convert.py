"""Pretrained and reference state dicts → the port's state dicts
(counterpart of ``awsegbench/models/convert.py``).

Not to be confused with ``awsegbench_torch/convert.py``, which maps the
JAX package's Flax variables to the port's state dict and back. This
module takes the state dicts other projects publish:

* a Hugging Face ``SegformerModel`` (MiT encoder) state dict;
* a torchvision-style ResNet-50 state dict, with its BN running stats
  (``num_batches_tracked`` is not read);
* a reference-trained ``EnsembleModel`` or one of its members.

Each is first mapped, key by key, into the Flax-shaped tree the JAX
package builds (the same numpy code, kept here so that the port imports
nothing of it), then through ``convert.flax_to_torch`` to the port's
keys, which carry the Flax scope names. So the port grafts exactly what
the JAX package grafts. Inputs are ``{name: ndarray}`` dicts (a tensor
works where ``np.asarray`` takes it); outputs are f32 CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..convert import flax_to_torch


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))      # OIHW → HWIO


_dwconv = _conv                               # (C, 1, kH, kW) → (kH, kW, 1, C)


def _dense(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _put(tree: Dict, path: str, value: np.ndarray) -> None:
    node = tree
    keys = path.split('/')
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _hf_segformer_tree(state_dict: Mapping[str, np.ndarray],
                       depths: Sequence[int], prefix: str) -> Dict:
    """HF ``SegformerModel`` keys → the MiTEncoder's Flax params tree."""
    sd = {k[len(prefix):] if k.startswith(prefix) else k: np.asarray(v)
          for k, v in state_dict.items()}
    params: Dict = {}

    def put(path: str, value: np.ndarray) -> None:
        _put(params, path, value)

    block_idx = 0
    for s in range(len(depths)):
        pe = f'encoder.patch_embeddings.{s}'
        put(f'OverlapPatchEmbed_{s}/Conv_0/kernel', _conv(sd[f'{pe}.proj.weight']))
        put(f'OverlapPatchEmbed_{s}/Conv_0/bias', sd[f'{pe}.proj.bias'])
        put(f'OverlapPatchEmbed_{s}/LayerNorm_0/scale', sd[f'{pe}.layer_norm.weight'])
        put(f'OverlapPatchEmbed_{s}/LayerNorm_0/bias', sd[f'{pe}.layer_norm.bias'])

        for j in range(depths[s]):
            hb = f'encoder.block.{s}.{j}'
            ob = f'SegFormerBlock_{block_idx}'
            block_idx += 1

            put(f'{ob}/LayerNorm_0/scale', sd[f'{hb}.layer_norm_1.weight'])
            put(f'{ob}/LayerNorm_0/bias', sd[f'{hb}.layer_norm_1.bias'])
            attn = f'{hb}.attention'
            oa = f'{ob}/EfficientSelfAttention_0'
            put(f'{oa}/Dense_0/kernel', _dense(sd[f'{attn}.self.query.weight']))
            put(f'{oa}/Dense_0/bias', sd[f'{attn}.self.query.bias'])
            if f'{attn}.self.sr.weight' in sd:
                put(f'{oa}/Conv_0/kernel', _conv(sd[f'{attn}.self.sr.weight']))
                put(f'{oa}/Conv_0/bias', sd[f'{attn}.self.sr.bias'])
                put(f'{oa}/LayerNorm_0/scale', sd[f'{attn}.self.layer_norm.weight'])
                put(f'{oa}/LayerNorm_0/bias', sd[f'{attn}.self.layer_norm.bias'])
            put(f'{oa}/Dense_1/kernel', _dense(sd[f'{attn}.self.key.weight']))
            put(f'{oa}/Dense_1/bias', sd[f'{attn}.self.key.bias'])
            put(f'{oa}/Dense_2/kernel', _dense(sd[f'{attn}.self.value.weight']))
            put(f'{oa}/Dense_2/bias', sd[f'{attn}.self.value.bias'])
            put(f'{oa}/Dense_3/kernel', _dense(sd[f'{attn}.output.dense.weight']))
            put(f'{oa}/Dense_3/bias', sd[f'{attn}.output.dense.bias'])

            put(f'{ob}/LayerNorm_1/scale', sd[f'{hb}.layer_norm_2.weight'])
            put(f'{ob}/LayerNorm_1/bias', sd[f'{hb}.layer_norm_2.bias'])
            om = f'{ob}/MixFFN_0'
            put(f'{om}/Dense_0/kernel', _dense(sd[f'{hb}.mlp.dense1.weight']))
            put(f'{om}/Dense_0/bias', sd[f'{hb}.mlp.dense1.bias'])
            put(f'{om}/Conv_0/kernel', _dwconv(sd[f'{hb}.mlp.dwconv.dwconv.weight']))
            put(f'{om}/Conv_0/bias', sd[f'{hb}.mlp.dwconv.dwconv.bias'])
            put(f'{om}/Dense_1/kernel', _dense(sd[f'{hb}.mlp.dense2.weight']))
            put(f'{om}/Dense_1/bias', sd[f'{hb}.mlp.dense2.bias'])

        put(f'LayerNorm_{s}/scale', sd[f'encoder.layer_norm.{s}.weight'])
        put(f'LayerNorm_{s}/bias', sd[f'encoder.layer_norm.{s}.bias'])
    return params


def _convert_bn(sd: Mapping[str, np.ndarray], torch_prefix: str,
                params: Dict, stats: Dict, flax_prefix: str) -> None:
    _put(params, f'{flax_prefix}/scale', np.asarray(sd[f'{torch_prefix}.weight']))
    _put(params, f'{flax_prefix}/bias', np.asarray(sd[f'{torch_prefix}.bias']))
    _put(stats, f'{flax_prefix}/mean',
         np.asarray(sd[f'{torch_prefix}.running_mean']))
    _put(stats, f'{flax_prefix}/var',
         np.asarray(sd[f'{torch_prefix}.running_var']))


def _resnet_tree(state_dict: Mapping[str, np.ndarray],
                 layers: Sequence[int]) -> Dict:
    """torchvision ResNet keys → the ResNetEncoder's Flax variables."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    params: Dict = {}
    stats: Dict = {}
    _put(params, 'Conv_0/kernel', _conv(sd['conv1.weight']))     # stem
    _convert_bn(sd, 'bn1', params, stats, 'BatchNorm_0')
    block_idx = 0
    for s, n_blocks in enumerate(layers):
        for j in range(n_blocks):
            tb = f'layer{s + 1}.{j}'
            ob = f'Bottleneck_{block_idx}'
            block_idx += 1
            # ConvBNReLU_0 = 1×1 reduce, ConvBNReLU_1 = 3×3
            _put(params, f'{ob}/ConvBNReLU_0/Conv_0/kernel',
                 _conv(sd[f'{tb}.conv1.weight']))
            _convert_bn(sd, f'{tb}.bn1', params, stats,
                        f'{ob}/ConvBNReLU_0/BatchNorm_0')
            _put(params, f'{ob}/ConvBNReLU_1/Conv_0/kernel',
                 _conv(sd[f'{tb}.conv2.weight']))
            _convert_bn(sd, f'{tb}.bn2', params, stats,
                        f'{ob}/ConvBNReLU_1/BatchNorm_0')
            _put(params, f'{ob}/Conv_0/kernel', _conv(sd[f'{tb}.conv3.weight']))
            _convert_bn(sd, f'{tb}.bn3', params, stats, f'{ob}/BatchNorm_0')
            if f'{tb}.downsample.0.weight' in sd:
                _put(params, f'{ob}/Conv_1/kernel',
                     _conv(sd[f'{tb}.downsample.0.weight']))
                _convert_bn(sd, f'{tb}.downsample.1', params, stats,
                            f'{ob}/BatchNorm_1')
    return {'params': params, 'batch_stats': stats}


def _convert_head_stack(sd: Mapping[str, np.ndarray], torch_prefix: str,
                        layer_idx: Sequence[int], params: Dict, stats: Dict,
                        flax_prefix: str) -> None:
    """A torch ``nn.Sequential`` head: ``layer_idx`` lists the Sequential
    indices of its convs and BNs in order, named Conv_0, BatchNorm_0,
    Conv_1, ... as the heads' Flax scopes."""
    conv_i = bn_i = 0
    for idx in layer_idx:
        if f'{torch_prefix}.{idx}.running_mean' in sd:      # BatchNorm2d
            _convert_bn(sd, f'{torch_prefix}.{idx}', params, stats,
                        f'{flax_prefix}/BatchNorm_{bn_i}')
            bn_i += 1
        else:                                               # Conv2d
            _put(params, f'{flax_prefix}/Conv_{conv_i}/kernel',
                 _conv(np.asarray(sd[f'{torch_prefix}.{idx}.weight'])))
            _put(params, f'{flax_prefix}/Conv_{conv_i}/bias',
                 np.asarray(sd[f'{torch_prefix}.{idx}.bias']))
            conv_i += 1


def _convert_conv_bn(sd: Mapping[str, np.ndarray], conv_key: str,
                     bn_prefix: str, params: Dict, stats: Dict,
                     flax_prefix: str) -> None:
    """A bias-free conv + BN pair → a ConvBNReLU scope."""
    _put(params, f'{flax_prefix}/Conv_0/kernel', _conv(np.asarray(sd[conv_key])))
    _convert_bn(sd, bn_prefix, params, stats, f'{flax_prefix}/BatchNorm_0')


def _convert_sep_conv(sd: Mapping[str, np.ndarray], torch_prefix: str,
                      params: Dict, stats: Dict, flax_prefix: str) -> None:
    """A depthwise + pointwise + BN triple (``.dw``/``.pw``/``.bn``) → a
    SeparableConvBNReLU scope."""
    _put(params, f'{flax_prefix}/Conv_0/kernel',
         _dwconv(np.asarray(sd[f'{torch_prefix}.dw.weight'])))
    _put(params, f'{flax_prefix}/Conv_1/kernel',
         _conv(np.asarray(sd[f'{torch_prefix}.pw.weight'])))
    _convert_bn(sd, f'{torch_prefix}.bn', params, stats,
                f'{flax_prefix}/BatchNorm_0')


def _reference_segformer_tree(state_dict: Mapping[str, np.ndarray],
                              prefix: str) -> Dict:
    sd = {k[len(prefix):]: np.asarray(v) for k, v in state_dict.items()
          if k.startswith(prefix)}
    params: Dict = {}
    stats: Dict = {}
    params['MiTEncoder_0'] = _hf_segformer_tree(sd, (2, 2, 2, 2), 'segformer.')
    # seg head Sequential: 0=Conv3×3, 1=BN, 2=ReLU, 3=Dropout, 4=Conv1×1
    _convert_head_stack(sd, 'segmentation_head', (0, 1, 4), params, stats,
                        'SegmentationHead_0')
    if 'depth_head.depth_head.0.weight' in sd:
        # depth head Sequential: 0=Conv, 1=BN, 4=Conv, 5=BN, 7=Conv1×1
        _convert_head_stack(sd, 'depth_head.depth_head', (0, 1, 4, 5, 7),
                            params, stats, 'DepthEstimationHead_0')
    return {'params': params, 'batch_stats': stats}


def _reference_deeplab_tree(state_dict: Mapping[str, np.ndarray],
                            prefix: str, layers: Sequence[int]) -> Dict:
    sd = {k[len(prefix):]: np.asarray(v) for k, v in state_dict.items()
          if k.startswith(prefix)}
    enc = _resnet_tree({k[len('model.encoder.'):]: v for k, v in sd.items()
                        if k.startswith('model.encoder.')}, layers)
    params: Dict = {'ResNetEncoder_0': enc['params']}
    stats: Dict = {'ResNetEncoder_0': enc['batch_stats']}

    _convert_conv_bn(sd, 'model.aspp.b0.conv.weight', 'model.aspp.b0.bn',
                     params, stats, 'ASPP_0/ConvBNReLU_0')
    for i in range(3):
        _convert_sep_conv(sd, f'model.aspp.sep{i}', params, stats,
                          f'ASPP_0/SeparableConvBNReLU_{i}')
    _convert_conv_bn(sd, 'model.aspp.pool.conv.weight', 'model.aspp.pool.bn',
                     params, stats, 'ASPP_0/ConvBNReLU_1')
    _convert_conv_bn(sd, 'model.aspp.proj.conv.weight', 'model.aspp.proj.bn',
                     params, stats, 'ASPP_0/ConvBNReLU_2')
    _convert_sep_conv(sd, 'model.pre', params, stats, 'SeparableConvBNReLU_0')
    _convert_conv_bn(sd, 'model.low_proj.conv.weight', 'model.low_proj.bn',
                     params, stats, 'ConvBNReLU_0')
    _convert_sep_conv(sd, 'model.fuse', params, stats, 'SeparableConvBNReLU_1')
    _put(params, 'Conv_0/kernel', _conv(np.asarray(sd['model.cls.weight'])))
    _put(params, 'Conv_0/bias', np.asarray(sd['model.cls.bias']))
    if 'depth_head.depth_head.0.weight' in sd:
        _convert_head_stack(sd, 'depth_head.depth_head', (0, 1, 4, 5, 7),
                            params, stats, 'DepthEstimationHead_0')
    return {'params': params, 'batch_stats': stats}


def convert_hf_segformer_encoder(state_dict: Mapping[str, np.ndarray],
                                 depths: Sequence[int] = (2, 2, 2, 2),
                                 prefix: str = '') -> dict[str, torch.Tensor]:
    """HF ``SegformerModel`` (encoder) state dict → the state dict of the
    port's ``MiTEncoder`` (``OverlapPatchEmbed_0.Conv_0.weight``, ...).
    ``prefix`` strips a leading name (e.g. 'segformer.')."""
    return flax_to_torch({'params': _hf_segformer_tree(state_dict, depths,
                                                       prefix)})


def convert_torch_resnet_encoder(state_dict: Mapping[str, np.ndarray],
                                 layers: Sequence[int] = (3, 4, 6, 3)
                                 ) -> dict[str, torch.Tensor]:
    """torchvision-style ResNet state dict (``conv1/bn1/layer{1..4}``) →
    the state dict of the port's ``ResNetEncoder``, its BN running stats
    (``running_mean``, ``running_var``) included."""
    return flax_to_torch(_resnet_tree(state_dict, layers))


def convert_reference_segformer_member(state_dict: Mapping[str, np.ndarray],
                                       prefix: str = ''
                                       ) -> dict[str, torch.Tensor]:
    """Reference ``SegFormerModel`` member state dict (HF MiT encoder under
    ``segformer.``, ``segmentation_head``, ``depth_head.depth_head``) →
    the port's ``SegFormerModel`` state dict. Only keys under ``prefix``
    are read, with it stripped."""
    return flax_to_torch(_reference_segformer_tree(state_dict, prefix))


def convert_reference_deeplab_member(state_dict: Mapping[str, np.ndarray],
                                     prefix: str = '',
                                     layers: Sequence[int] = (3, 4, 6, 3)
                                     ) -> dict[str, torch.Tensor]:
    """Reference ``DeepLabV3PlusModel`` member state dict (an encoder with
    torchvision ResNet naming under ``model.encoder.``, ASPP branches
    ``model.aspp.{b0,sep0..2,pool,proj}``, decoder ``model.{pre,low_proj,
    fuse,cls}`` and ``depth_head``) → the port's ``DeepLabV3PlusModel``
    state dict."""
    return flax_to_torch(_reference_deeplab_tree(state_dict, prefix, layers))


def convert_reference_ensemble(state_dict: Mapping[str, np.ndarray]
                               ) -> dict[str, torch.Tensor]:
    """Full reference ``EnsembleModel`` state dict → the port's
    ``EnsembleModel`` state dict, with the ensemble weights and the
    temperature: the migration path for reference-trained checkpoints."""
    seg = _reference_segformer_tree(state_dict, 'segformer.')
    dlv = _reference_deeplab_tree(state_dict, 'deeplabv3plus.', (3, 4, 6, 3))
    params = {'segformer': seg['params'], 'deeplabv3plus': dlv['params'],
              'ensemble_weights': np.asarray(state_dict['ensemble_weights'])}
    if 'temperature' in state_dict:
        params['temperature'] = np.asarray(state_dict['temperature'])
    return flax_to_torch({'params': params,
                          'batch_stats': {'segformer': seg['batch_stats'],
                                          'deeplabv3plus': dlv['batch_stats']}})


def merge_encoder_params(target: Mapping[str, torch.Tensor],
                         encoder: Mapping[str, torch.Tensor],
                         encoder_scope: str) -> dict[str, torch.Tensor]:
    """A new state dict: ``target`` with every entry under
    ``encoder_scope`` (e.g. 'segformer.MiTEncoder_0') replaced by the
    converted ``encoder`` state dict. ``target`` is not changed."""
    head = encoder_scope + '.'
    out = {k: v for k, v in target.items() if not k.startswith(head)}
    out.update({head + k: v for k, v in encoder.items()})
    return out
