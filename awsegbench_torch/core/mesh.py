"""The device mesh over ``torch.distributed`` (counterpart of
``awsegbench/core/mesh.py``).

JAX drives every device of a host from one process and shards arrays over
a ``Mesh``; PyTorch runs one process per device (``torchrun``) and joins
them in a process group. The port takes PyTorch's idiom: a
:class:`DataMesh` is this process's rank and the size of one mesh axis
(by default ``'data'``) over a process group, and every batch-wide
quantity is reduced across its ranks with an explicit collective
(``parallel/collectives.py``). With no process group up, the mesh is the
one process alone (rank 0 of 1), and no collective runs.

A ``{'data': d, 'model': m}`` mesh with ``m > 1`` is a :class:`TPMesh`:
the world's ranks laid out as JAX lays out its devices,
``np.arange(world).reshape(d, m)`` (world rank = data index·m + model
index), with one process group per row (the ``model`` axis: the ranks
that share the data index) and one per column (the ``data`` axis: the
ranks that share the model index). Its ``.data`` is the ``DataMesh`` every
data-parallel piece takes (batch rows, tiles, the loader's slice, the
reductions of the loss, BN and the sweep's counts); its ``.model`` is the
group that tensor parallelism (``parallel/tensor.py``) shards parameters
over, where :func:`tp_param_shardings` says, JAX's rule in torch's layout.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place on one mesh axis (``axis``, by default
    ``'data'``): its ``rank`` among ``size`` ranks of the process ``group``
    (``None``: the default group, or no group when ``size`` is 1). As the
    1-D ``('data',)`` mesh it is its own ``.data`` and has no model
    axis."""

    rank: int = 0
    size: int = 1
    group: Any = None
    axis: str = DATA_AXIS

    has_model_axis = False

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis,)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.size}

    @property
    def backend(self) -> str | None:
        return dist.get_backend(self.group) if self.size > 1 else None

    @property
    def data(self) -> 'DataMesh':
        return self

    @property
    def model(self) -> 'DataMesh':
        return DataMesh(axis=MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """The 2-D ``('data', 'model')`` mesh: ``data`` and ``model`` are this
    process's places on the two axes (their groups are its column and its
    row of the rank grid); ``rank`` and ``size`` are the world's, and
    ``group`` (``None``) the world's group, so that :func:`replicate` and
    the world's barriers take the mesh as they take a ``DataMesh``."""

    data: DataMesh
    model: DataMesh
    rank: int
    size: int
    group: Any = None

    axis_names = (DATA_AXIS, MODEL_AXIS)

    @property
    def has_model_axis(self) -> bool:
        return self.model.size > 1

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data.size, MODEL_AXIS: self.model.size}

    @property
    def backend(self) -> str | None:
        return dist.get_backend() if self.size > 1 else None


Mesh = Union[DataMesh, TPMesh]


def has_model_axis(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` has a ``'model'`` axis above 1 (JAX's name)."""
    return mesh is not None and bool(mesh.has_model_axis)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Joins this process to the process group, once.

    The rank, world size and address come from the arguments or, where
    they are not given, from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). ``backend`` defaults
    to ``'nccl'`` where a card is present and ``'gloo'`` on the CPU; two
    ranks that share one card need ``'gloo'`` (NCCL takes one card per
    rank). Under NCCL the process takes ``cuda:LOCAL_RANK``. Returns True
    when a group is up, False for a single process (no address given and
    no world above 1), as the JAX function does."""
    if dist.is_available() and dist.is_initialized():
        return True
    env_world = int(os.environ.get('WORLD_SIZE', '1'))
    if coordinator_address is None and num_processes in (None, 1) \
            and env_world <= 1:
        return False
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    world = num_processes if num_processes is not None else env_world
    rank = (process_id if process_id is not None
            else int(os.environ.get('RANK', '0')))
    if backend == 'nccl':
        local = int(os.environ.get('LOCAL_RANK',
                                   rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    init_method = (f'tcp://{coordinator_address}' if coordinator_address
                   else 'env://')
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    logger.info('torch.distributed initialized: rank %d/%d over %s',
                dist.get_rank(), dist.get_world_size(), backend)
    return True


def create_mesh(devices: Optional[Sequence[Any]] = None,
                mesh_shape: Any = 'auto') -> Mesh:
    """The mesh over the world.

    ``devices`` (one entry per rank) may name the mesh's extent, which
    must be the world's size. ``mesh_shape`` is ``'auto'`` (the 1-D
    ``('data',)`` mesh) or a dict such as ``{'data': d, 'model': m}``,
    whose size must equal the world's (``ValueError`` otherwise, as in
    JAX). Without a ``'model'`` axis above 1 it is the 1-D
    :class:`DataMesh` over the world; with one, a :class:`TPMesh` whose
    rank grid is the world reshaped in the dict's axis order, as JAX
    reshapes its devices. Every rank creates every row's and every
    column's process group, in the same order (``dist.new_group`` is
    collective)."""
    up = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if up else 0
    world = dist.get_world_size() if up else 1
    if devices is not None and len(devices) != world:
        raise ValueError(f'{len(devices)} devices for a world of {world} '
                         'processes: the port runs one process per device')
    if mesh_shape in (None, 'auto'):
        return DataMesh(rank, world)
    if not isinstance(mesh_shape, dict):
        raise ValueError(f'Unsupported mesh_shape: {mesh_shape!r}')
    unknown = set(mesh_shape) - {DATA_AXIS, MODEL_AXIS}
    if unknown:
        raise ValueError(f'mesh_shape {mesh_shape}: unknown axes '
                         f'{sorted(unknown)}')
    sizes = [int(v) for v in mesh_shape.values()]
    total = int(np.prod(sizes))
    if total != world:
        raise ValueError(f'mesh_shape {mesh_shape} needs {total} devices, '
                         f'have {world}')
    m = int(mesh_shape.get(MODEL_AXIS, 1))
    if m == 1:
        return DataMesh(rank, world)
    names = list(mesh_shape)
    grid = np.arange(world).reshape(sizes)      # JAX's reshape of devices
    grid = (np.moveaxis(grid, names.index(DATA_AXIS), 0)
            if DATA_AXIS in names else grid[None]).reshape(-1, m)
    # grid[i, j]: the world rank at data index i, model index j
    meshes = {}
    for axis, lines in ((DATA_AXIS, grid.T), (MODEL_AXIS, grid)):
        for line in lines:                 # every rank, every group, in order
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                meshes[axis] = DataMesh(ranks.index(rank), len(ranks),
                                        group, axis)
    return TPMesh(meshes[DATA_AXIS], meshes[MODEL_AXIS], rank, world)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def mesh_rows(mesh: Mesh, n: int) -> slice:
    """The rows of a global batch of ``n`` (a multiple of the data axis's
    size) that ``mesh``'s rank holds on the data axis."""
    mesh = mesh.data
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global batch (a tree of arrays or tensors whose
    leading axis is the batch, which must divide by the data axis's size):
    rows ``[rank·b, (rank + 1)·b)`` for ``b = B / size`` on the data axis
    (the ranks of one data index hold the same rows)."""
    mesh = mesh.data

    def rows(x):
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f'batch of {n} does not divide over '
                             f'{mesh.size} ranks: pad it first '
                             '(pad_batch_to_multiple)')
        return x[mesh_rows(mesh, n)]
    return _map(rows, batch)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's values on every rank of the mesh (the world's, on a
    ``TPMesh``): each tensor of ``tree`` (a module's parameters and
    buffers, or a tree of tensors) is broadcast from rank 0 in place.
    Returns ``tree``."""
    if mesh.size <= 1:
        return tree
    from ..parallel.collectives import broadcast_
    if isinstance(tree, torch.nn.Module):
        for t in [*tree.parameters(), *tree.buffers()]:
            broadcast_(t.data, mesh)
        return tree
    _map(lambda t: broadcast_(t, mesh) if torch.is_tensor(t) else t, tree)
    return tree


def pad_batch_to_multiple(batch: Any, multiple: int) -> tuple[Any, int]:
    """Pads the leading axis of every leaf up to a multiple of
    ``multiple`` by repeating the last row (numpy, ``mode='edge'``).
    Returns (padded batch, original batch size); callers mask the padded
    rows out of losses and metrics."""
    leaves = []
    _map(leaves.append, batch)
    if not leaves:
        return batch, 0
    n = leaves[0].shape[0]
    rem = n % multiple
    if rem == 0:
        return batch, n
    pad = multiple - rem

    def _pad(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), widths, mode='edge')
    return _map(_pad, batch), n


# ---------------------------------------------------------------------------
# the model axis's layout (JAX's tp_param_shardings, in torch's layout)
# ---------------------------------------------------------------------------

def tp_param_shardings(model: torch.nn.Module, mesh: Mesh,
                       min_features: int = 64) -> dict[str, Optional[int]]:
    """The tensor-parallel layout of ``model``'s parameters on ``mesh``'s
    model axis (of size ``m``): ``{parameter name: the dim sharded over
    the model axis, or None for replicated}``, names as
    ``named_parameters()`` gives them (one process's names, which
    ``convert.flax_to_torch`` maps one to one onto Flax paths).

    JAX's rule (``awsegbench/core/mesh.py::tp_param_shardings``) read in
    torch's layout: a ≥2-D ``weight`` (a conv's OIHW, a Linear's [out,
    in]; JAX's ``kernel`` with its output features last) is sharded on
    dim 0 when its output features divide by ``m`` and number at least
    ``min_features``; a 1-D ``weight`` or ``bias`` (JAX's ``scale`` and
    ``bias``) on the same test of its length. Everything else stays
    replicated: the ensemble's mixing weights and temperature and the
    narrow leaves. BN's running statistics are buffers, not parameters,
    and stay replicated as JAX's ``batch_stats`` do."""
    m = mesh.model.size

    def rule(name: str, p: torch.Tensor) -> Optional[int]:
        leaf = name.rsplit('.', 1)[-1]
        if p.ndim == 0 or leaf not in ('weight', 'bias') \
                or leaf == 'bias' and p.ndim != 1:
            return None
        out = p.shape[0]
        return 0 if out % m == 0 and out >= min_features else None
    return {name: rule(name, p) for name, p in model.named_parameters()}


def opt_state_shardings(optimizer: torch.optim.Optimizer,
                        param_layout: dict[str, Optional[int]],
                        names: Sequence[str]
                        ) -> dict[str, dict[str, Optional[int]]]:
    """The layout of a torch optimiser's state (JAX's
    ``opt_state_shardings``): ``{parameter name: {state key: dim or
    None}}`` for the parameters of ``optimizer``, named by ``names`` in
    its parameters' order. A state tensor with its parameter's shape
    (AdamW's two moments) takes the parameter's layout; the rest (the
    step count) stays replicated."""
    params = [p for g in optimizer.param_groups for p in g['params']]
    out = {}
    for name, p in zip(names, params):
        out[name] = {k: (param_layout.get(name) if torch.is_tensor(v)
                         and v.shape == p.shape and v.ndim else None)
                     for k, v in optimizer.state.get(p, {}).items()}
    return out


def param_shardings(model: torch.nn.Module, mesh: Mesh,
                    min_features: int = 64) -> dict[str, Optional[int]]:
    """Every parameter replicated (None) on a mesh without a model axis;
    :func:`tp_param_shardings` on one that has one."""
    if has_model_axis(mesh):
        return tp_param_shardings(model, mesh, min_features)
    return {name: None for name, _ in model.named_parameters()}

