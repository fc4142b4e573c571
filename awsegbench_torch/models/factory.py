"""Model factory (counterpart of ``awsegbench/models/factory.py``).

``create_model`` builds 'segformer' | 'deeplabv3plus' | 'ensemble' from a
plain dict (the model section of a config), initialises it from a seed and
puts it on the device in eval mode. The init is the port's own: He-normal
convs over their fan-in, truncated-normal 0.02 dense layers, zero
biases, identity norms, except the last BN of each ResNet residual branch,
whose scale starts at 0.25 (as the common zero-init of that scale, but
leaving the branch in play). With identity BN statistics that keeps the
activations' scale through the 16 residual blocks and the logits O(10);
the JAX package's fan-out init without it gives logits in the thousands,
where an f32 comparison at an absolute tolerance means little. Weights
for parity with the JAX package come from ``convert.flax_to_torch``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from .._device import resolve_device
from .deeplab import Bottleneck, DeepLabV3PlusModel
from .ensemble import EnsembleModel
from .heads import BatchNorm
from .segformer import SegFormerModel, mit_variant_config


def _init_(model: nn.Module, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=g)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                nn.init.trunc_normal_(mod.weight, std=0.02, a=-0.04, b=0.04,
                                      generator=g)
                mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for mod in model.modules():
            if isinstance(mod, Bottleneck):
                mod.BatchNorm_0.weight.fill_(0.25)


def create_model(config: Mapping[str, Any], device: str | torch.device = 'cuda',
                 seed: int = 0, dtype: torch.dtype = torch.float32) -> nn.Module:
    """Build, seed-initialise and place a model in eval mode.

    ``config`` is the model section (``{'type': 'ensemble', 'num_classes':
    19, ...}``) or a whole config holding it under ``'model'``."""
    dev = resolve_device(device)
    cfg = dict(config.get('model', config))
    kind = cfg.get('type', 'ensemble')
    num_classes = cfg.get('num_classes', 19)
    include_depth = cfg.get('include_depth', True)
    head_mode = cfg.get('head_mode', 'faithful')
    # The faithful heads always fuse an integer ×scale upsample into their
    # first conv (the same function; a non-integer scale is materialised,
    # decided from the shapes). The JAX config's switch has no other value.
    if cfg.get('fused_upsample', True) is not True:
        raise ValueError('fused_upsample: only true is supported')
    variant = cfg.get('segformer_variant', 'b0')
    if kind == 'segformer':
        hidden_sizes, depths = mit_variant_config(variant)
        model = SegFormerModel(num_classes, include_depth, head_mode,
                               hidden_sizes, depths)
    elif kind == 'deeplabv3plus':
        model = DeepLabV3PlusModel(num_classes, include_depth)
    elif kind == 'ensemble':
        model = EnsembleModel(
            num_classes, include_depth,
            cfg.get('ensemble_strategy', 'weighted_average'),
            cfg.get('temperature_scaling', True), head_mode, variant)
    else:
        raise ValueError(f'Unknown model type: {kind}')
    _init_(model, seed)
    return model.to(device=dev, dtype=dtype).eval()


def count_parameters(model: nn.Module) -> int:
    """Total trainable parameter count."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
