"""Each configuration file's sizes are the ones the port builds from it, so
that the counts and the roofline readers, which read the file, count the
model that runs."""

import json

import pytest

from portbench import harness
from portbench.common import port

CONFIGS = sorted((harness.HERE / 'configs').glob('*.json'))


def segformer_sizes(model) -> dict:
    enc, sf = model.segformer.MiTEncoder_0, model.segformer
    embeds = [getattr(enc, f'OverlapPatchEmbed_{i}').Conv_0 for i in range(4)]
    hidden = [c.out_channels for c in embeds]
    blocks = [b for n, b in enc.named_children()
              if n.startswith('SegFormerBlock_')]
    stages = [[b for b in blocks if b.LayerNorm_0.normalized_shape[0] == c]
              for c in hidden]

    def per_stage(get):
        values = [{get(b) for b in s} for s in stages]
        assert all(len(v) == 1 for v in values)
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


def deeplab_sizes(model) -> dict:
    dl = model.deeplabv3plus
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


@pytest.mark.parametrize('path', CONFIGS, ids=lambda p: p.stem)
def test_config_sizes_are_the_built_model(path):
    config = json.loads(path.read_text())
    model = port.skeleton(config)
    assert config['segformer'] == segformer_sizes(model)
    assert config['deeplab'] == deeplab_sizes(model)
    assert (model.deeplabv3plus.Conv_0.out_channels
            == config['model']['num_classes'])
