"""Flax ``EnsembleModel`` variables ↔ the port's state dict.

The port names its submodules after the Flax scopes, so the map is
mechanical: the scope path joined with '.' is the module path, and only
the leaf name and the layout change.

* conv kernel HWIO (kH, kW, Cin, Cout) → OIHW (Cout, Cin, kH, kW); a
  depthwise kernel (kH, kW, 1, C) → (C, 1, kH, kW) by the same transpose;
* Dense kernel [in, out] → Linear weight [out, in];
* LayerNorm / BatchNorm ``scale`` → ``weight``; ``bias`` stays;
* BatchNorm ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` /
  ``running_var``.

Takes numpy arrays (no JAX needed): ``{'params': {...}, 'batch_stats':
{...}}`` nested dicts as Flax returns them, after ``jax.device_get``.
:func:`torch_to_flax` is the inverse, for a state dict or for the
parameters' gradients, so tests compare the two leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_LEAF = {('params', 'scale'): 'weight', ('params', 'bias'): 'bias',
         ('batch_stats', 'mean'): 'running_mean',
         ('batch_stats', 'var'): 'running_var'}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map every leaf of ``variables`` to a state-dict entry; raises on a
    leaf it does not know, so nothing is dropped silently."""
    sd: dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, value in _flatten(tree):
            a = np.asarray(value)
            *scope, leaf = path
            if collection == 'params' and leaf == 'kernel':
                if a.ndim == 4:
                    a, name = a.transpose(3, 2, 0, 1), 'weight'
                elif a.ndim == 2:
                    a, name = a.T, 'weight'
                else:
                    raise ValueError(f'kernel of rank {a.ndim} at {path}')
            elif (collection, leaf) in _LEAF:
                name = _LEAF[(collection, leaf)]
            elif collection == 'params' and not scope:
                name = leaf      # ensemble_weights, temperature
            else:
                raise ValueError(f'unknown variable {collection}/{"/".join(path)}')
            key = '.'.join([*scope, name])
            if key in sd:
                raise ValueError(f'two variables map to {key}')
            sd[key] = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return sd


def torch_to_flax(tensors: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """Map state-dict entries (or gradients by parameter name) back to a
    Flax-shaped ``{'params': ..., 'batch_stats': ...}`` tree of f32 numpy
    arrays; raises on a name it does not know."""
    inv = {v: k for k, v in _LEAF.items()}
    tree: dict[str, Any] = {}
    for key, value in tensors.items():
        a = value.detach().float().cpu().numpy()
        *scope, name = key.split('.')
        if name == 'weight' and a.ndim in (2, 4):
            collection, leaf = 'params', 'kernel'
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        elif name in ('weight', 'bias', 'running_mean', 'running_var'):
            collection, leaf = inv[name]
        elif not scope:
            collection, leaf = 'params', name
        else:
            raise ValueError(f'unknown state-dict entry {key}')
        node = tree.setdefault(collection, {})
        for part in scope:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree
