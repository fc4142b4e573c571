"""Mixed-precision policy (counterpart of ``awsegbench/core/precision.py``).

The JAX train step casts the f32 parameters (and batch statistics) to the
compute dtype and runs the whole forward in it. The port does the same
with a whole-model cast, not ``torch.autocast``, whose per-op dtype lists
differ from it: :meth:`Policy.cast_to_compute` gives the parameters cast to
the compute dtype, for ``torch.func.functional_call``. The cast is part of
the autograd graph, so the gradients land on the f32 masters in f32. BN
reads its running statistics in the parameters' (compute) dtype when it
updates them (``models/heads.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype
    compute_dtype: torch.dtype

    def cast_to_compute(self, module: nn.Module, buffers: bool = False
                        ) -> dict[str, torch.Tensor]:
        """The module's floating parameters, by name, cast to the compute
        dtype (a differentiable cast; the masters themselves when the
        dtypes agree); with ``buffers``, its BN running statistics too (the
        eval forward's, as JAX casts ``batch_stats``)."""
        tensors = dict(module.named_parameters())
        if buffers:
            tensors.update(module.named_buffers())
        return {name: t.to(self.compute_dtype) if t.is_floating_point() else t
                for name, t in tensors.items()}


def get_policy(name: str = 'bf16') -> Policy:
    if name in ('bf16', 'bfloat16', 'mixed'):
        return Policy(torch.float32, torch.bfloat16)
    if name in ('fp32', 'float32', 'full'):
        return Policy(torch.float32, torch.float32)
    raise ValueError(f'Unknown precision policy: {name}')
