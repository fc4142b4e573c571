"""DeepLabV3+ alone (the factory's ``deeplabv3plus`` type): ResNet-50 at
output stride 16, ASPP, the ×4 decoder and the depth head, one model's
logits."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..counts import flops

OUTPUTS = ('segmentation',)
MEMBERS = ()


def skeleton(config: Mapping[str, Any]) -> torch.nn.Module:
    from awsegbench_torch.models.deeplab import DeepLabV3PlusModel
    m = config['model']
    with torch.device('meta'):
        return DeepLabV3PlusModel(m['num_classes'], m['include_depth'])


def section(dl: torch.nn.Module) -> dict:
    """The ``deeplab`` size section of a built DeepLabV3+."""
    enc, aspp = dl.ResNetEncoder_0, dl.ASPP_0
    firsts, i = [], 0
    for n in enc.stages:
        firsts.append(getattr(enc, f'Bottleneck_{i}'))
        i += n
    stride = enc.Conv_0.stride[0] * 2              # the stem and its pool
    for b in firsts:
        stride *= b.ConvBNReLU_1.Conv_0.stride[0]
    return {
        'encoder': f'resnet{3 * sum(enc.stages) + 2}',
        'layers': list(enc.stages),
        'widths': [b.ConvBNReLU_0.Conv_0.out_channels for b in firsts],
        'output_stride': stride,
        'atrous_rates': [getattr(aspp, f'SeparableConvBNReLU_{k}')
                         .Conv_0.dilation[0] for k in range(3)],
        'decoder_channels': aspp.ConvBNReLU_0.Conv_0.out_channels,
        'low_level_channels': dl.ConvBNReLU_0.Conv_0.out_channels,
        'depth_head_hidden': dl.DepthEstimationHead_0.Conv_0.out_channels,
    }


def sizes(model: torch.nn.Module) -> dict:
    return {'deeplab': section(model),
            'model': {'num_classes': model.Conv_0.out_channels}}


def forward_flops(config: Mapping[str, Any], height: int,
                  width: int) -> float:
    m = config['model']
    return flops.deeplab(height, width, config['deeplab'], m['num_classes'],
                         m['include_depth'])


def spans(model: torch.nn.Module) -> list[tuple]:
    return [(model, 'forward', 'sweep.deeplab')]
