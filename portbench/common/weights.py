"""Seeded random weights for a model's state dict, made on the device in
one large draw.

Pretrained files are not in the repository, so both sides get the same
seeded weights: convolutions He-normal over their fan-in, dense layers
normal(0, 0.02) clipped at two deviations, norm scales 1 + N(0, 0.1), every
bias and norm offset N(0, 0.02), BN running means N(0, 0.05) and variances
exp(N(0, 0.1)), the last BN scale of each ResNet residual branch ×0.25 (as
the port's own init: it keeps the activations' scale through the 16
blocks), the ensemble's member weights 0.5 + N(0, 0.05) and its
temperature 1 + N(0, 0.05)."""

from __future__ import annotations

import re

import torch

_RESIDUAL_BN = re.compile(r'Bottleneck_\d+\.BatchNorm_0\.weight$')


def _stats(name: str, shape: tuple[int, ...]) -> tuple[float, float, str]:
    """(mean, deviation, kind) of the leaf ``name``; kind 'exp' draws
    exp(N(mean, dev)), 'clip' a normal clipped at two deviations."""
    if name.endswith('running_var'):
        return 0.0, 0.1, 'exp'
    if name.endswith('running_mean'):
        return 0.0, 0.05, 'normal'
    if name.endswith('ensemble_weights'):
        return 0.5, 0.05, 'normal'
    if name.endswith('temperature'):
        return 1.0, 0.05, 'normal'
    if name.endswith('bias'):
        return 0.0, 0.02, 'normal'
    if len(shape) == 4:
        fan_in = shape[1] * shape[2] * shape[3]
        return 0.0, (2.0 / fan_in) ** 0.5, 'normal'
    if len(shape) == 2:
        return 0.0, 0.02, 'clip'
    scale = 0.25 if _RESIDUAL_BN.search(name) else 1.0
    return scale, 0.1 * scale, 'normal'


def make_state(shapes: dict[str, tuple[int, ...]], seed: int,
               device: str | torch.device,
               dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """A state dict of the leaves ``shapes`` (name → shape), drawn from
    ``seed`` on ``device`` in one call and held in ``dtype`` (the values
    are rounded to it once; every consumer gets the same numbers)."""
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (name, shape), z in zip(shapes.items(), flat.split(sizes)):
        mean, dev, kind = _stats(name, tuple(shape))
        if kind == 'clip':
            z = z.clamp(-2.0, 2.0)
        v = z.view(shape) * dev + mean
        out[name] = (v.exp() if kind == 'exp' else v).to(dtype)
    return out


def shapes_of(module: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    """The state dict's leaves and their shapes, in order."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
