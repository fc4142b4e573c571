"""The data mesh over ``torch.distributed`` (counterpart of
``awsegbench/core/mesh.py``).

JAX drives every device of a host from one process and shards arrays over
a ``Mesh``; PyTorch runs one process per device (``torchrun``) and joins
them in a process group. The port takes PyTorch's idiom: a
:class:`DataMesh` is this process's rank and the world's size along the
one ``'data'`` axis, and every batch-wide quantity is reduced across the
ranks with an explicit collective (``parallel/collectives.py``). With no
process group up, the mesh is the one process alone (rank 0 of 1), and no
collective runs.

Only the data axis is ported. A ``'model'`` axis above 1 (JAX's tensor
parallelism, ``tp_param_shardings`` and ``opt_state_shardings``) raises:
in torch it means weights sharded as DTensors, which the kernels that take
raw device pointers (K3–K10) cannot read without a design of their own.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

MODEL_AXIS_MESSAGE = (
    "a 'model' mesh axis above 1 (tensor parallelism) is not ported: it "
    'waits for the next slice of the multi-device port (ROADMAP.md §1), '
    'weights sharded as DTensors around the kernels')


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place on the 1-D ``('data',)`` mesh: its ``rank``
    among ``size`` ranks of the process ``group`` (``None``: the default
    group, or no group when ``size`` is 1)."""

    rank: int = 0
    size: int = 1
    group: Any = None

    axis_names = (DATA_AXIS,)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.size}

    @property
    def backend(self) -> str | None:
        return dist.get_backend(self.group) if self.size > 1 else None


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
                mesh_shape: Any = 'auto') -> DataMesh:
    """The 1-D ``('data',)`` mesh over the world.

    ``devices`` (one entry per rank) may name the mesh's extent, which
    must be the world's size. ``mesh_shape`` is ``'auto'`` or a dict such
    as ``{'data': n}``, whose size must equal the world's (``ValueError``
    otherwise, as in JAX); a ``'model'`` axis above 1 raises
    ``NotImplementedError``."""
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
    if int(mesh_shape.get(MODEL_AXIS, 1)) > 1:
        raise NotImplementedError(f'mesh_shape {mesh_shape}: '
                                  f'{MODEL_AXIS_MESSAGE}')
    total = int(np.prod([int(v) for v in mesh_shape.values()]))
    if total != world:
        raise ValueError(f'mesh_shape {mesh_shape} needs {total} devices, '
                         f'have {world}')
    return DataMesh(rank, world)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def mesh_rows(mesh: DataMesh, n: int) -> slice:
    """The rows of a global batch of ``n`` (a multiple of the mesh's size)
    that ``mesh``'s rank holds."""
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(batch: Any, mesh: DataMesh) -> Any:
    """This rank's rows of a global batch (a tree of arrays or tensors whose
    leading axis is the batch, which must divide by the mesh's size):
    rows ``[rank·b, (rank + 1)·b)`` for ``b = B / size``."""
    def rows(x):
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f'batch of {n} does not divide over '
                             f'{mesh.size} ranks: pad it first '
                             '(pad_batch_to_multiple)')
        return x[mesh_rows(mesh, n)]
    return _map(rows, batch)


def replicate(tree: Any, mesh: DataMesh) -> Any:
    """Rank 0's values on every rank: each tensor of ``tree`` (a module's
    parameters and buffers, or a tree of tensors) is broadcast from rank 0
    in place. Returns ``tree``."""
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
