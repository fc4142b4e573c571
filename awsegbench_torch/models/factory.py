"""Model factory (counterpart of ``awsegbench/models/factory.py``).

``create_model`` builds 'segformer' | 'deeplabv3plus' | 'ensemble' |
'mask2former' | 'mask2former_swin' from a plain dict (the model section
of a config), initialises it from a seed and puts it on the device in
eval mode (``TrainStep`` keeps its f32 parameters and switches it to
train mode). The init is the port's own: He-normal
convs over their fan-in, truncated-normal 0.02 dense layers, zero
biases, identity norms, except the last BN of each ResNet residual branch,
whose scale starts at 0.25 (as the common zero-init of that scale, but
leaving the branch in play), Mask2Former's parts as
``mask2former.init_parameters`` says (the deformable attention's offsets
start at the published grid) and Swin's as ``swin.init_parameters`` says
(the relative position bias tables). With identity BN statistics that
keeps the activations' scale through the 16 residual blocks and the
logits O(10); the JAX package's fan-out init without it gives logits in
the thousands, where an f32 comparison at an absolute tolerance means
little. Weights for parity with the JAX package come from
``convert.flax_to_torch``.

Pretrained encoders are grafted where the JAX package grafts them: in the
trainer, through :func:`init_model_variables` (``models/pretrained.py``),
not here, so a model built to load a checkpoint reads no weights file.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from .._device import resolve_device
from ..utils.config import check_tpu_section
from .deeplab import Bottleneck, DeepLabV3PlusModel
from .ensemble import EnsembleModel
from .heads import BatchNorm
from .mask2former import Mask2FormerModel, init_parameters, mask2former_swin
from .pretrained import apply_pretrained
from .segformer import SegFormerModel, mit_variant_config, mit_variant_name
from .swin import init_parameters as init_swin


def init_model(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise ``model``'s weights in place from ``seed`` (the port's
    init above); returns the model."""
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
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for mod in model.modules():
            if isinstance(mod, Bottleneck):
                mod.BatchNorm_0.weight.fill_(0.25)
        init_parameters(model, g)
        init_swin(model, g)
    return model


def create_model(config: Mapping[str, Any], device: str | torch.device = 'cuda',
                 seed: int | None = None,
                 dtype: torch.dtype = torch.float32) -> nn.Module:
    """Build, seed-initialise and place a model in eval mode.

    ``config`` is the model section (``{'type': 'ensemble', 'num_classes':
    19, ...}``) or a whole config holding it under ``'model'`` (a dict or a
    ``utils.config.Config``); then its ``tpu`` section is checked
    (``check_tpu_section``). ``seed`` defaults to the config's ``seed``
    (0 when it has none). ``remat`` (the model section's, else the
    ``tpu`` section's, default false) checkpoints the MiT encoder's blocks
    in training. ``pretrained`` is read by :func:`init_model_variables`,
    not here."""
    dev = resolve_device(device)
    whole = config.get('model') is not None
    check_tpu_section(config if whole else {'model': config})
    if seed is None:
        seed = config.get('seed', 0)
    cfg = dict(config.get('model', config))
    # remat: recompute each encoder block in the backward (activation
    # memory for one more encoder forward); the model section decides first
    tpu = (config.get('tpu') or {}) if whole else {}
    remat = bool(cfg.get('remat', tpu.get('remat', False)))
    kind = cfg.get('type', 'ensemble')
    num_classes = cfg.get('num_classes', 19)
    include_depth = cfg.get('include_depth', True)
    head_mode = cfg.get('head_mode', 'faithful')
    # The faithful heads always fuse an integer ×scale upsample into their
    # first conv (the same function; a non-integer scale is materialised,
    # decided from the shapes). The JAX config's switch has no other value.
    if cfg.get('fused_upsample', True) is not True:
        raise ValueError('fused_upsample: only true is supported')
    # The MiT variant: 'segformer_variant' (strict), else a Hugging Face
    # 'model_name' id, where an id that names no variant falls back to b0.
    variant = cfg.get('segformer_variant')
    if variant is None:
        variant = mit_variant_name(cfg.get('model_name', 'b0'), default='b0')
    if kind == 'segformer':
        hidden_sizes, depths = mit_variant_config(variant)
        model = SegFormerModel(num_classes, include_depth, head_mode,
                               hidden_sizes, depths, remat=remat)
    elif kind == 'deeplabv3plus':
        model = DeepLabV3PlusModel(num_classes, include_depth)
    elif kind == 'mask2former':
        model = Mask2FormerModel(num_classes)
    elif kind == 'mask2former_swin':
        # the Swin-L of the published Cityscapes model; a 'swin' section
        # (embed_dim, depths, heads, window, mlp_ratio) replaces sizes
        model = mask2former_swin(num_classes, **(cfg.get('swin') or {}))
    elif kind == 'ensemble':
        model = EnsembleModel(
            num_classes, include_depth,
            cfg.get('ensemble_strategy', 'weighted_average'),
            cfg.get('temperature_scaling', True), head_mode, variant,
            remat=remat)
    else:
        raise ValueError(f'Unknown model type: {kind}')
    init_model(model, seed)
    return model.to(device=dev, dtype=dtype).eval()


def init_model_variables(model: nn.Module, config: Mapping[str, Any],
                         weights_dir: str | None = None) -> nn.Module:
    """Graft the cached pretrained encoders into ``model`` in place when the
    config's ``model.pretrained`` is true, as it is when the key is absent
    (``apply_pretrained``; a missing cache leaves the random init with a
    warning). ``config`` is a whole config (dict or ``Config``). Returns
    the model."""
    model_cfg = dict(config.get('model') or {})
    if model_cfg.get('pretrained', True):
        apply_pretrained(model, model_cfg, weights_dir)
    return model


def count_parameters(model: nn.Module) -> int:
    """Total trainable parameter count."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
