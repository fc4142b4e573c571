"""The hand-written eval kernels as ``torch.library`` custom ops.

``awseg::sr_attention`` (K1, ``csrc/sr_attention.cu``),
``awseg::seg_core`` (K2, ``csrc/seg_head.cu``),
``awseg::ms_deform_attn`` (K11, ``csrc/ms_deform_attn.cu``) and
``awseg::bn_act`` (K12, ``csrc/bn_act.cu``) are graph nodes, so
``torch.export`` records the op and not the Python dispatch around the
kernel. Each op has a CPU kernel (the plain version), a CUDA kernel (the
ctypes launch of the hand-written kernel, which counts the launch) and a
fake implementation that computes the output's shape and dtype only, with
no guard on the batch, so a symbolic batch survives the trace. No kernel is
registered for any other device, so there the op raises.

The ops take no gradient: training calls the autograd paths of
``ops/attention.py`` and the train head kernels, never these ops. A
serving artifact that holds the ops needs this module imported before
``torch.export.load``; it imports only torch and the kernel modules.
"""

from __future__ import annotations

import functools

import torch

from . import attention, bn_act as bna, headkernels, ms_deform_attn as msda

sr_attention = torch.library.custom_op(
    'awseg::sr_attention', attention.sr_attention_plain, mutates_args=(),
    device_types='cpu')
sr_attention.register_kernel('cuda', attention._launch)


@sr_attention.register_fake
def _sr_attention_fake(q, k, v, scale):
    attention._check(q, k, v, 'sr_attention')
    return q.new_empty(q.shape)


seg_core = torch.library.custom_op(
    'awseg::seg_core', headkernels.seg_core_plain, mutates_args=(),
    device_types='cpu')
seg_core.register_kernel('cuda', headkernels._launch)


@seg_core.register_fake
def _seg_core_fake(P, a1, c1, wp, bp, r):
    headkernels.check_shapes(P, wp, a1, c1, bp, r, 'seg_core')
    b, h, w, _, _ = P.shape
    return P.new_empty((b, h * r, w * r, wp.shape[1]))


ms_deform_attn = torch.library.custom_op(
    'awseg::ms_deform_attn', msda.ms_deform_attn_plain, mutates_args=(),
    device_types='cpu')
ms_deform_attn.register_kernel('cuda', msda._launch)


@ms_deform_attn.register_fake
def _ms_deform_attn_fake(value, shapes, loc, attn):
    msda.check(value, shapes, loc, attn)
    b, _, m, d = value.shape
    return value.new_empty((b, loc.shape[1], m * d))


bn_act = torch.library.custom_op(
    'awseg::bn_act', bna.bn_act_plain, mutates_args=(), device_types='cpu')
bn_act.register_kernel('cuda', bna._launch)


@bn_act.register_fake
def _bn_act_fake(x, mean, var, weight, bias, eps, residual=None, relu=False):
    if not all(t.shape == (x.shape[1],) for t in (mean, var, weight, bias)):
        raise ValueError(f'bn_act: the per-channel tensors need '
                         f'{x.shape[1]} values each')
    # the plain version's dtype: every operand's, promoted
    dtype = functools.reduce(torch.promote_types, (
        t.dtype for t in (x, mean, var, weight, bias, residual)
        if t is not None))
    return torch.empty_like(x, dtype=dtype)
