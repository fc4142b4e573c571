"""Tensor parallelism over the mesh's ``'model'`` axis (counterpart of the
JAX package's ``tp_param_shardings`` layout, ``awsegbench/core/mesh.py``,
as the JAX trainer places it).

JAX annotates the parameters with ``NamedSharding``s and lets GSPMD
partition the program. The port keeps PyTorch's idiom of the data axis
instead: plain local tensors, explicit collectives over the model
group, and autograd ``Function``s where a gradient crosses ranks. The
kernels (K2, K7–K10 through ctypes on raw pointers) could not read a
``DTensor``, so every kernel gets its weights gathered to full size just
before it launches and runs exactly as on one process.

:func:`shard_model_` keeps each parameter that the layout shards (dim 0,
``core.mesh.tp_param_shardings``) as this rank's slice ``[r·n/m,
(r + 1)·n/m)``, so its gradient and AdamW's two moments have the slice's
shape too. The modules that hold such a slice change class in place to a
subclass (:func:`tensor_parallel_class`) whose state-dict names are the
one-process names:

* a ``Conv2d`` or ``Linear`` computes only its own output channels, from
  :func:`copy_to_model` of its (replicated) input, adds its own bias and
  returns :func:`gather_from_model` of them along the channel dim; a
  grouped (depthwise) conv takes its own input channels instead
  (:func:`split_to_model`);
* every other read of a sharded parameter (LayerNorm's and BN's scale and
  bias, the weights that ``hwio(...)`` hands to the kernels, the seg and
  depth heads' biases) returns it gathered, through the subclass's
  ``__getattr__``: one all-gather per read, the same reads in the same
  order on every rank of the model group.

The replicated parameters' gradients and the BN statistics are averaged
over the model group after the backward (:func:`average_replicated_`),
so they stay bit-equal on its ranks.

Everything after a gather is the same replicated computation on every
model rank, so the gradient that reaches a gathered tensor is the whole
gradient on every rank: the gather's backward takes this rank's slice of
it (``torch.distributed.nn``'s ``all_gather`` would sum, giving ``m``
times the gradient). A column-parallel layer's input gradient is a sum
over its output channels, which the ranks hold in parts: the copy's
backward all-reduces it. The data axis's reductions (BN's batch
statistics, the loss, the gradients) stay on the data group
(``parallel.collectives``).

Under the ``gloo`` backend the collectives go through the host
(``collectives._comm_device``), as the data axis's do. :func:`record_comm`
counts each kind of collective, its bytes and its time (synchronised
around the collective, so only while recording).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import time
from typing import Any, Iterator, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.mesh import DataMesh, Mesh
from .collectives import _all_gather, all_reduce_

__all__ = ['CommLog', 'average_replicated_', 'copy_to_model',
           'full_optimizer_state_dict',
           'full_state_dict', 'gather_from_model', 'is_sharded',
           'load_full_optimizer_state_dict_', 'load_full_state_dict_',
           'local_slice', 'record_comm', 'shard_model_', 'shard_of',
           'split_to_model', 'tensor_parallel_class']

# the attribute a sharded Parameter carries: (dim, the model axis's mesh)
_SHARD_ATTR = '_awseg_model_shard'


# ---------------------------------------------------------------------------
# recording the collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CommLog:
    """Per kind of collective: calls, bytes (the gathered or reduced
    tensor's) and seconds (host clock, the device synchronised before and
    after). Kinds: ``'activation_gather'`` (a layer's output channels),
    ``'param_gather'`` (a sharded parameter read whole: the kernels'
    weights, the norms' scales and biases), ``'input_all_reduce'`` (a
    column-parallel layer's input gradient), ``'input_gather'`` (a grouped
    conv's input gradient)."""

    calls: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)
    seconds: dict = dataclasses.field(default_factory=dict)

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds


_LOG: contextvars.ContextVar[Optional[CommLog]] = contextvars.ContextVar(
    'awseg_model_comm_log', default=None)


@contextlib.contextmanager
def record_comm(log: Optional[CommLog] = None) -> Iterator[CommLog]:
    """Within the block, the model axis's collectives are logged into
    ``log`` (a new :class:`CommLog` by default), their backward ones
    included (each Function keeps the log it was called under)."""
    log = log if log is not None else CommLog()
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


def _logged(log: Optional[CommLog], kind: str, t: torch.Tensor, fn):
    """``fn()``, logged under ``kind`` with ``t``'s bytes when recording."""
    if log is None:
        return fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    log.add(kind, out.numel() * out.element_size(),
            time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# the collectives, as autograd Functions
# ---------------------------------------------------------------------------

def local_slice(t: torch.Tensor, dim: int, mesh: DataMesh) -> torch.Tensor:
    """This rank's slice ``[r·n/m, (r + 1)·n/m)`` of ``t`` along ``dim``
    (a view)."""
    n = t.shape[dim]
    if n % mesh.size:
        raise ValueError(f'dim {dim} of {tuple(t.shape)} does not divide '
                         f'over {mesh.size} model ranks')
    k = n // mesh.size
    return t.narrow(dim, mesh.rank * k, k)


def _gather(t: torch.Tensor, dim: int, mesh: DataMesh) -> torch.Tensor:
    return torch.cat(_all_gather(t, mesh), dim=dim)


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim``; the backward takes this rank's slice."""

    @staticmethod
    def forward(ctx, t, dim, mesh, kind):
        ctx.dim, ctx.mesh = dim, mesh
        return _logged(_LOG.get(), kind, t, lambda: _gather(t, dim, mesh))

    @staticmethod
    def backward(ctx, grad):
        return (local_slice(grad, ctx.dim, ctx.mesh).contiguous(), None,
                None, None)


class _SplitToModel(torch.autograd.Function):
    """This rank's slice along ``dim``; the backward all-gathers."""

    @staticmethod
    def forward(ctx, t, dim, mesh):
        ctx.dim, ctx.mesh, ctx.log = dim, mesh, _LOG.get()
        return local_slice(t, dim, mesh).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _logged(ctx.log, 'input_gather', grad, lambda: _gather(
            grad, ctx.dim, ctx.mesh)), None, None


class _CopyToModel(torch.autograd.Function):
    """The identity; the backward all-reduces over the model group."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.log = mesh, _LOG.get()
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _logged(ctx.log, 'input_all_reduce', grad, lambda: all_reduce_(
            grad.contiguous().clone(), ctx.mesh)), None


def _dim(t: torch.Tensor, dim: int) -> int:
    return dim % t.ndim


def gather_from_model(t: torch.Tensor, dim: int, mesh: DataMesh,
                      kind: str = 'activation_gather') -> torch.Tensor:
    """Every model rank's ``t`` concatenated along ``dim``, in rank order;
    its gradient is this rank's slice of the incoming one (the computation
    after the gather is replicated over the model group)."""
    if mesh.size <= 1:
        return t
    return _GatherFromModel.apply(t, _dim(t, dim), mesh, kind)


def split_to_model(t: torch.Tensor, dim: int, mesh: DataMesh
                   ) -> torch.Tensor:
    """This rank's slice of a replicated ``t`` along ``dim``; its gradient
    is every rank's slice gathered."""
    if mesh.size <= 1:
        return t
    return _SplitToModel.apply(t, _dim(t, dim), mesh)


def copy_to_model(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``t`` (replicated over the model group); its gradient is summed over
    the model group (each rank's layer contributes its channels' part)."""
    if mesh.size <= 1:
        return t
    return _CopyToModel.apply(t, mesh)


# ---------------------------------------------------------------------------
# the sharded modules
# ---------------------------------------------------------------------------

def _gathered_getattr(self, name: str):
    """A sharded parameter is read whole (gathered over the model group);
    everything else as ``nn.Module`` finds it."""
    dims = self.__dict__.get('_tp_dims')
    if dims is not None and name in dims:
        return gather_from_model(self._parameters[name], dims[name],
                                 self._tp_mesh, 'param_gather')
    return nn.Module.__getattr__(self, name)


def _column_forward(self, x: torch.Tensor) -> torch.Tensor:
    """This rank's output channels of the layer, gathered along the channel
    dim (last for a Linear, 1 for an NCHW conv)."""
    mesh = self._tp_mesh
    w, b = self._parameters['weight'], self._parameters.get('bias')
    if isinstance(self, nn.Linear):
        return gather_from_model(F.linear(copy_to_model(x, mesh), w, b), -1,
                                 mesh)
    if self.groups == 1:
        y = F.conv2d(copy_to_model(x, mesh), w, b, self.stride,
                     self.padding, self.dilation)
    else:   # this rank's groups take their own input channels
        y = F.conv2d(split_to_model(x, 1, mesh), w, b, self.stride,
                     self.padding, self.dilation, self.groups // mesh.size)
    return gather_from_model(y, 1, mesh)


@functools.cache
def tensor_parallel_class(cls: type) -> type:
    """The subclass of module class ``cls`` that a module holding sharded
    parameters takes: sharded parameters read whole, and for ``Conv2d``
    and ``Linear`` the column-parallel forward."""
    body = {'__getattr__': _gathered_getattr,
            '__doc__': f'``{cls.__name__}`` with parameters sharded over the '
                       'model axis (``parallel/tensor.py``).'}
    if issubclass(cls, (nn.Conv2d, nn.Linear)):
        body['forward'] = _column_forward
    return type(f'TensorParallel{cls.__name__}', (cls,), body)


def shard_of(p: torch.Tensor) -> Optional[tuple[int, DataMesh]]:
    """(dim, model mesh) of a parameter that :func:`shard_model_` sharded;
    None for a replicated one."""
    return getattr(p, _SHARD_ATTR, None)


def _check_layer(name: str, mod: nn.Module, dims: Mapping[str, int],
                 mesh: DataMesh) -> None:
    if not isinstance(mod, (nn.Conv2d, nn.Linear)):
        return
    wanted = {'weight'} | ({'bias'} if mod.bias is not None else set())
    if set(dims) != wanted or set(dims.values()) != {0}:
        raise ValueError(f'{name}: a column-parallel layer shards its weight '
                         f'and bias on dim 0, not {dict(dims)}')
    if isinstance(mod, nn.Conv2d) and (
            mod.padding_mode != 'zeros' or (mod.groups > 1 and (
                mod.groups % mesh.size
                or mod.in_channels % mesh.size))):
        raise ValueError(f'{name}: a conv with padding {mod.padding_mode!r} '
                         f'and {mod.groups} groups cannot shard over '
                         f'{mesh.size} model ranks')


def shard_model_(model: nn.Module, mesh: Mesh,
                 layout: Mapping[str, Optional[int]]) -> nn.Module:
    """Shards ``model`` in place over ``mesh``'s model axis by ``layout``
    (``{parameter name: dim or None}``, ``core.mesh.tp_param_shardings``):
    each sharded parameter keeps this rank's slice (the same Parameter
    object, so an optimiser built before keeps it), and each module that
    holds one takes its :func:`tensor_parallel_class`. Parameters must be
    full and equal on the model group's ranks (``core.mesh.replicate``
    first); an optimiser built before has no state yet. Returns
    ``model``."""
    mm = mesh.model
    if mm.size <= 1:
        return model
    if is_sharded(model):
        raise ValueError('the model is sharded already')
    by_module: dict[str, dict[str, int]] = {}
    for name, dim in layout.items():
        if dim is not None:
            mod_name, _, leaf = name.rpartition('.')
            by_module.setdefault(mod_name, {})[leaf] = dim
    for mod_name, dims in by_module.items():
        mod = model.get_submodule(mod_name)
        _check_layer(mod_name, mod, dims, mm)
        for leaf, dim in dims.items():
            p = mod._parameters[leaf]
            p.data = local_slice(p.data, dim, mm).clone()
            setattr(p, _SHARD_ATTR, (dim, mm))
        mod._tp_dims, mod._tp_mesh = dict(dims), mm
        mod.__class__ = tensor_parallel_class(type(mod))
    return model


@torch.no_grad()
def average_replicated_(model: nn.Module, mesh: Mesh) -> None:
    """Every replicated parameter's gradient and every floating buffer (BN's
    running statistics) of ``model`` averaged over ``mesh``'s model group,
    in place, in one all-reduce. The ranks of a model group compute these
    from the same inputs, but a card's kernels need not round alike from
    run to run (cuDNN's backward, atomics), and AdamW would carry their
    last-bit differences into the weights; averaged, they are bit-equal on
    every rank (a value equal on all ranks stays as it is)."""
    mm = mesh.model
    if mm.size <= 1:
        return
    params = [p for p in model.parameters() if shard_of(p) is None]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    ts = [p.grad for p in params] + [b for b in model.buffers()
                                     if b.is_floating_point()]
    flat = all_reduce_(torch.cat([t.reshape(-1).float() for t in ts]), mm)
    flat /= mm.size
    for t, part in zip(ts, flat.split([t.numel() for t in ts])):
        t.copy_(part.view_as(t))


def is_sharded(model: nn.Module) -> bool:
    """Whether :func:`shard_model_` sharded any of ``model``'s parameters."""
    return any(m.__dict__.get('_tp_dims') for m in model.modules())


def _sharded_names(model: nn.Module) -> Iterator[tuple[str, int, DataMesh]]:
    for mod_name, mod in model.named_modules():
        for leaf, dim in (mod.__dict__.get('_tp_dims') or {}).items():
            yield (f'{mod_name}.{leaf}' if mod_name else leaf, dim,
                   mod._tp_mesh)


def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """``model``'s state dict with every sharded parameter gathered to full
    size: one process's names, shapes and values, on every rank (a
    collective over the model group)."""
    sd = model.state_dict()
    for name, dim, mesh in _sharded_names(model):
        sd[name] = _gather(sd[name], dim, mesh)
    return sd


def load_full_state_dict_(model: nn.Module,
                          state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Loads one process's state dict into a sharded (or unsharded) model:
    each sharded parameter takes this rank's slice. Returns ``model``."""
    state = dict(state)
    for name, dim, mesh in _sharded_names(model):
        state[name] = local_slice(state[name], dim, mesh)
    model.load_state_dict(state)
    return model


def _optimizer_params(optimizer: torch.optim.Optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g['params']]


def _moment(v: Any, shape: torch.Size) -> bool:
    """Whether optimiser state ``v`` is a per-element moment of a
    parameter of ``shape`` (AdamW's two; its step count is not)."""
    return torch.is_tensor(v) and v.ndim > 0 and v.shape == shape


def full_optimizer_state_dict(optimizer: torch.optim.Optimizer
                              ) -> dict[str, Any]:
    """The torch optimiser's state dict in one process's format: every
    moment of a sharded parameter gathered to full size (a collective over
    the model group)."""
    state = optimizer.state_dict()
    per = dict(state['state'])
    for i, p in enumerate(_optimizer_params(optimizer)):
        shard = shard_of(p)
        if shard is None or i not in per:
            continue
        dim, mesh = shard
        per[i] = {k: _gather(v, dim, mesh) if _moment(v, p.shape) else v
                  for k, v in per[i].items()}
    return dict(state, state=per)


def load_full_optimizer_state_dict_(optimizer: torch.optim.Optimizer,
                                    state: Mapping[str, Any]) -> None:
    """Loads one process's optimiser state dict: every moment of a
    sharded parameter takes this rank's slice."""
    per = dict(state['state'])
    for i, p in enumerate(_optimizer_params(optimizer)):
        shard = shard_of(p)
        if shard is None or i not in per:
            continue
        dim, mesh = shard
        full = list(p.shape)
        full[dim] *= mesh.size
        per[i] = {k: local_slice(v, dim, mesh).clone()
                  if _moment(v, torch.Size(full)) else v
                  for k, v in per[i].items()}
    optimizer.load_state_dict(dict(state, state=per))
