"""The control's precision: the reference with its products computed in
float8 (e4m3).

The configuration computes in bf16 (over f32 masters); the step below it
that would tempt a later change is fp8. Under :class:`Fp8Operands` every
product, forward and backward (the convolutions and their backward,
``linear``, ``matmul``, ``einsum``, ``mm``, ``bmm``, ``addmm``,
``baddbmm``), takes e4m3 operands and stores an e4m3 result: each tensor
scaled by its largest magnitude onto e4m3's range (448), rounded to
``torch.float8_e4m3fn`` and scaled back. Norms, softmax and the other
elementwise work stay f32 (per-tensor e4m3 flushes a BN variance to 0),
as does the optimiser's update of the f32 masters (outside the mode)."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

E4M3_MAX = 448.0
aten = torch.ops.aten
# op → the positions of its operands that go in as fp8 (under autograd the
# mode sees the decomposed ops, under inference mode the composite ones)
PRODUCTS = {aten.convolution.default: (0, 1),
            aten.convolution_backward.default: (0, 1, 2),
            aten.conv2d.default: (0, 1), aten.linear.default: (0, 1),
            aten.matmul.default: (0, 1), aten.einsum.default: (1,),
            aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
            aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2)}


def fp8(t):
    """``t`` rounded to e4m3 under a per-tensor scale, in ``t``'s dtype
    (each tensor of a list)."""
    if isinstance(t, (list, tuple)):
        return type(t)(fp8(x) for x in t)
    if not (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel()):
        return t
    amax = t.abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class Fp8Operands(TorchDispatchMode):
    """Computes the products in e4m3 while it is entered."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        where = PRODUCTS.get(func)
        if where:
            args = tuple(fp8(a) if i in where else a
                         for i, a in enumerate(args))
        out = func(*args, **(kwargs or {}))
        return tree_map(fp8, out) if where else out
