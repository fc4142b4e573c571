"""The one table of the ``awseg::`` custom ops: every hand-written kernel.

Each op's CPU kernel is the plain version and its CUDA kernel the launch
(``_build.launch``, which counts it); no other device has a kernel. The
public functions of ``ops/`` call the ops, so a traced graph holds them.
Gradients (``register_autograd``): K1's is the op
``awseg::sr_attention_backward`` (K6), K7's and K9's ``<name>_grad`` (K8
or K10, then the scatter); each saves what its kernel recomputes from, and
on the CPU is autograd through the plain forward. Train-mode BN's
(``awseg::bn_train``, K13) is ``awseg::bn_train_backward`` (K14), the
gradient's formula on the CPU. The eval kernels (K2, K11, K12, K15) take
the plain version's autograd on the CPU and raise on the card. The eval
ops (K1, K2, K11, K12, K15) and K13/K14 have fakes that compute the
output's shape and dtype with no guard on the batch, so a symbolic batch
survives ``torch.export``; a serving artifact needs this module imported
before ``torch.export.load``.
"""

from __future__ import annotations

import functools

import torch

from ..parallel.collectives import active_mesh, data_parallel
from . import attention, bn_act as bna, bn_train as bnt
from . import depthkernels_train as dk, splat
from . import headkernels, headkernels_train as ht, ms_deform_attn as msda
from . import window_attention as wa

# The launch table's keys (``_build.launches``): each op that launches a
# kernel of csrc/, and the designs it chooses from by the dtype (counted
# in ``_build.design_launches``).
KERNEL_OPS: dict[str, tuple[str, ...]] = {}


def _op(name: str, schema: str, cpu, cuda, designs=()):
    """The op ``awseg::<name>`` of ``schema``: ``cpu`` on CPU tensors (an
    output that is a view is copied, so that, as the launches' outputs, it
    takes in-place writes under autograd), ``cuda`` on CUDA tensors;
    entered in ``KERNEL_OPS`` with ``designs`` unless None."""
    def cpu_kernel(*args):
        out = cpu(*args)
        outs = out if isinstance(out, tuple) else (out,)
        outs = tuple(t.clone() if t._is_view() else t for t in outs)
        return outs if isinstance(out, tuple) else outs[0]

    op = torch.library.custom_op(f'awseg::{name}', cpu_kernel,
                                 mutates_args=(), device_types='cpu',
                                 schema=schema)
    op.register_kernel('cuda', cuda)
    if designs is not None:
        KERNEL_OPS[name] = designs
    return op


def _plain_grad(plain, args, grad):
    """Autograd through ``plain(*args)`` for the output gradient ``grad``:
    the gradient of each floating-point tensor in ``args``, None for the
    rest."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_()
                  if isinstance(a, torch.Tensor) and a.is_floating_point()
                  else a for a in args]
        wrt = [i for i, a in enumerate(leaves)
               if isinstance(a, torch.Tensor) and a.requires_grad]
        got = dict(zip(wrt, torch.autograd.grad(
            plain(*leaves), [leaves[i] for i in wrt], grad)))
    return tuple(got.get(i) for i in range(len(args)))


def _with_autograd(fn):
    """``fn`` with autograd's dispatch keys back on, for the CPU kernels
    that are autograd through a plain forward: an op's kernel runs below
    autograd, where no operation records a graph."""
    @functools.wraps(fn)
    def kernel(*args):
        excluded = torch._C._dispatch_tls_local_exclude_set()
        for key in ('AutogradFunctionality', 'AutogradOther',
                    'AutogradNestedTensor'):
            excluded = excluded.remove(getattr(torch._C.DispatchKey, key))
        with torch._C._ForceDispatchKeyGuard(
                torch._C._dispatch_tls_local_include_set(), excluded):
            return fn(*args)
    return kernel


def _eval_only(op, plain):
    """Register the eval kernels' gradient rule on ``op``: the plain
    version's autograd on CPU tensors; on CUDA tensors the forward raises
    when a gradient is needed."""
    def setup_context(ctx, inputs, output):
        if any(isinstance(a, torch.Tensor) and a.is_cuda for a in inputs):
            raise NotImplementedError(f'{op._name}: the CUDA kernel is eval '
                                      'only')
        is_tensor = [isinstance(a, torch.Tensor) for a in inputs]
        ctx.save_for_backward(*(a if t else None
                                for a, t in zip(inputs, is_tensor)))
        ctx.rest = [None if t else a for a, t in zip(inputs, is_tensor)]

    def backward(ctx, grad):
        args = [a if t is None else t
                for a, t in zip(ctx.rest, ctx.saved_tensors)]
        return _plain_grad(plain, args, grad)

    op.register_autograd(backward, setup_context=setup_context)


# --- eval: K1 (and its backward, K6), K2, K11, K12, K15

sr_attention = _op(
    'sr_attention', '(Tensor q, Tensor k, Tensor v, float scale) -> Tensor',
    attention.sr_attention_plain, attention._launch, attention.DESIGNS)


@sr_attention.register_fake
def _sr_attention_fake(q, k, v, scale):
    attention._check(q, k, v, 'sr_attention')
    return q.new_empty(q.shape)


sr_attention_backward = _op(
    'sr_attention_backward', '(Tensor q, Tensor k, Tensor v, Tensor dout, '
    'float scale) -> (Tensor, Tensor, Tensor)',
    _with_autograd(attention.sr_attention_backward_plain),
    attention._launch_backward, attention.DESIGNS)


def _sr_attention_setup(ctx, inputs, output):
    q, k, v, ctx.scale = inputs
    ctx.save_for_backward(q, k, v)


def _sr_attention_grad(ctx, dout):
    q, k, v = ctx.saved_tensors
    return (*torch.ops.awseg.sr_attention_backward(
        q, k, v, dout.contiguous(), ctx.scale), None)


sr_attention.register_autograd(_sr_attention_grad,
                               setup_context=_sr_attention_setup)

seg_core = _op(
    'seg_core', '(Tensor P, Tensor a1, Tensor c1, Tensor wp, Tensor bp, '
    'int r) -> Tensor', headkernels.seg_core_plain, headkernels._launch,
    headkernels.DESIGNS)
_eval_only(seg_core, headkernels.seg_core_plain)


@seg_core.register_fake
def _seg_core_fake(P, a1, c1, wp, bp, r):
    headkernels.check_shapes(P, wp, a1, c1, bp, r, 'seg_core')
    b, h, w, _, _ = P.shape
    return P.new_empty((b, h * r, w * r, wp.shape[1]))


ms_deform_attn = _op(
    'ms_deform_attn', '(Tensor value, int[] shapes, Tensor loc, Tensor attn)'
    ' -> Tensor', msda.ms_deform_attn_plain, msda._launch)
_eval_only(ms_deform_attn, msda.ms_deform_attn_plain)


@ms_deform_attn.register_fake
def _ms_deform_attn_fake(value, shapes, loc, attn):
    msda.check(value, shapes, loc, attn)
    b, _, m, d = value.shape
    return value.new_empty((b, loc.shape[1], m * d))


window_attention = _op(
    'window_attention', '(Tensor qkv, Tensor table, int heads, int window, '
    'int shift, float scale) -> Tensor', wa.window_attention_plain,
    wa._launch, wa.DESIGNS)
_eval_only(window_attention, wa.window_attention_plain)


@window_attention.register_fake
def _window_attention_fake(qkv, table, heads, window, shift, scale):
    wa.check(qkv, table, heads, window, shift)
    b, hp, wp, c3 = qkv.shape
    return qkv.new_empty((b, hp, wp, c3 // 3))


bn_act = _op(
    'bn_act', '(Tensor x, Tensor mean, Tensor var, Tensor weight, '
    'Tensor bias, float eps, Tensor? residual=None, bool relu=False) -> '
    'Tensor', bna.bn_act_plain, bna._launch)
_eval_only(bn_act, bna.bn_act_plain)


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


# --- the splat masks: K3, K4, K5

_SPLAT = '(Tensor params, int height, int width) -> Tensor'
splat_coverage_batched = _op('splat_coverage_batched', _SPLAT,
                             splat.splat_coverage_plain,
                             splat._launch_batched)
splat_coverage_windowed = _op('splat_coverage_windowed', _SPLAT,
                              splat.splat_coverage_image_plain,
                              splat._launch_windowed)
splat_coverage_tiled = _op('splat_coverage_tiled', _SPLAT,
                           splat.splat_coverage_image_plain,
                           splat._launch_tiled)


# --- train: K13 and its gradient, K14

bn_train = _op(
    'bn_train', '(Tensor x, Tensor weight, Tensor bias, float eps, '
    'Tensor? residual=None, bool relu=False) -> (Tensor, Tensor)',
    bnt.bn_train_plain, bnt._launch_forward)
bn_train_backward = _op(
    'bn_train_backward', '(Tensor dy, Tensor x, Tensor? y, Tensor stats, '
    'Tensor weight, bool want_dres) -> (Tensor, Tensor, Tensor)',
    bnt.bn_train_backward_plain, bnt._launch_backward)


@bn_train.register_fake
def _bn_train_fake(x, weight, bias, eps, residual=None, relu=False):
    dtype = torch.promote_types(x.dtype, weight.dtype)
    if residual is not None:
        dtype = torch.promote_types(dtype, residual.dtype)
    return (torch.empty_like(x, dtype=dtype),
            x.new_empty((4, x.shape[1]),
                        dtype=torch.promote_types(x.dtype, torch.float32)))


@bn_train_backward.register_fake
def _bn_train_backward_fake(dy, x, y, stats, weight, want_dres):
    return (torch.empty_like(x),
            torch.empty_like(dy) if want_dres else dy.new_empty(0),
            weight.new_empty((2, x.shape[1])))


def _bn_train_setup(ctx, inputs, output):
    x, weight, _, _, residual, ctx.relu = inputs
    y, stats = output
    ctx.residual = residual is not None
    # the backward runs on autograd's thread, outside the caller's mesh
    ctx.mesh = active_mesh()
    ctx.mark_non_differentiable(stats)
    ctx.save_for_backward(x, y if ctx.relu else None, stats, weight)


def _bn_train_grad(ctx, dy, _):
    x, y, stats, weight = ctx.saved_tensors
    with data_parallel(ctx.mesh):
        dx, dres, dwb = bn_train_backward(dy, x, y, stats, weight,
                                          ctx.relu and ctx.residual)
    if not ctx.residual:
        dres = None
    elif not ctx.relu:
        dres = dy
    return dx, dwb[0], dwb[1], None, dres, None


bn_train.register_autograd(_bn_train_grad, setup_context=_bn_train_setup)


# --- train: K7/K8 and K9/K10, with the scatter

def _packed(grads):
    """(dP or dpp, the other gradients flat in f32, concatenated): K8's and
    K10's column sums are one tensor (ops return no outputs that alias
    each other; ``headkernels_train.split_sums`` parts them)."""
    first, *rest = grads
    return first, torch.cat([g.float().reshape(-1) for g in rest])


def _train_core(name, args, plain, plain_backward, kernels, n):
    """The ops of a train core: ``awseg::<name>`` (K7 or K9), whose gradient
    is ``awseg::<name>_grad`` (K8 or K10, then the scatter; on the CPU
    autograd through ``plain``), and ``awseg::<name>_backward`` (K8 or K10
    alone). ``args`` is the forward's schema, its first ``n`` tensors
    floating point; the forward saves its tensors, never its output."""
    backward_args = args.replace('float rate', 'Tensor dy, float rate')
    core = _op(name, f'({args}) -> Tensor', plain, kernels._launch_forward,
               headkernels.DESIGNS)
    _op(f'{name}_backward', f'({backward_args}) -> (Tensor, Tensor)',
        _with_autograd(lambda *a: _packed(plain_backward(*a))),
        kernels._launch_backward, headkernels.DESIGNS)

    def grad_cuda(*a):
        dpp, sums = kernels._launch_backward(*a)
        return ht._launch_pp_adjoint(dpp), sums

    def grad_cpu(*a):
        *ins, dy, rate, r = a
        return _packed(_plain_grad(plain, (*ins, rate, r), dy)[:n])

    grad = _op(f'{name}_grad', f'({backward_args}) -> (Tensor, Tensor)',
               _with_autograd(grad_cpu), grad_cuda, None)

    def setup_context(ctx, inputs, output):
        *tensors, ctx.rate, ctx.r = inputs
        ctx.save_for_backward(*tensors)

    def backward(ctx, dy):
        ins = ctx.saved_tensors
        dP, sums = grad(*ins, dy, ctx.rate, ctx.r)
        return (dP, *(g.to(t.dtype) for g, t in
                      zip(ht.split_sums(sums, ins[1:n]), ins[1:n])),
                *(None,) * (len(ins) - n + 2))

    core.register_autograd(backward, setup_context=setup_context)


_train_core('seg_core_train', 'Tensor P, Tensor a1, Tensor c1, Tensor wp, '
            'Tensor bp, Tensor seed, float rate, int r',
            ht.seg_core_train_plain, ht.seg_core_train_backward_plain, ht, 5)
_train_core('d1_core_train', 'Tensor P, Tensor a1, Tensor c1, Tensor seed, '
            'float rate, int r', dk.d1_core_train_plain,
            dk.d1_core_train_backward_plain, dk, 3)
neighbor_pp_adjoint = _op(
    'neighbor_pp_adjoint', '(Tensor dpp) -> Tensor',
    lambda dpp: ht._neighbor_pp_adjoint(dpp).to(dpp.dtype),
    ht._launch_pp_adjoint)
