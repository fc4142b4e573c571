"""Collectives over the data mesh and halo-exact spatial tiling
(counterpart of ``awsegbench/parallel/collectives.py``).

Collectives. ``psum_tree``, ``pmean_tree`` and ``all_gather_batch`` reduce
or gather tensors (and dicts of them) across the ranks of a
``core.mesh.DataMesh`` with ``torch.distributed``; ``sync_sum`` is the
differentiable sum the train step's batch-wide means take (BN's batch
statistics, the fused heads' batch sums, the loss's means). Its backward
sums the incoming gradients over the ranks, so when every rank backprops
its share ``L / world`` of the global loss ``L``, the ranks' parameter
gradients sum to the global batch's gradient (``train/trainer.py``). The
model code finds the mesh to reduce over through :func:`data_parallel`, a
context the train step enters around its forward and backward; outside
it, every sync is the identity. Under the ``gloo`` backend a CUDA tensor
goes through the host for the collective, and under NCCL a host tensor
through the card (two ranks sharing one card run over gloo, since NCCL
takes one card per rank).

Tiling. ``spatial_tiles`` cuts one [H, W, C] image into overlapping tiles
whose edge tiles clamp their origin inward (never padded: see
:func:`_tile_origin`), and ``stitch_tiles`` puts the tiles' cores back.
:class:`TileInfo` threads the grid through a model's forward, so that
the globally coupled ops (SR attention's K/V, ASPP) run on the assembled
full-image map and each stage's halo is refilled (``resync``): tiled
inference then equals the monolithic forward to f32 rounding. With a mesh
above one rank, ``tiled_forward`` gives each rank its share of the tiles,
and ``TileInfo.assemble_full`` all-gathers every rank's tiles.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.mesh import DATA_AXIS, DataMesh

__all__ = ['DATA_AXIS', 'TileInfo', 'all_gather_batch', 'all_gather_varlen',
           'choose_tile_grid',
           'data_parallel', 'first_row', 'global_rows', 'pmean_tree',
           'psum_tree', 'spatial_tiles', 'stitch_tiles', 'sync_sum',
           'tile_grid', 'tiled_forward']

_ACTIVE: contextvars.ContextVar[Optional[DataMesh]] = contextvars.ContextVar(
    'awseg_data_mesh', default=None)


@contextlib.contextmanager
def data_parallel(mesh: Optional[DataMesh]) -> Iterator[None]:
    """Within the block, batch-wide reductions of the model and the loss sum
    over ``mesh``'s ranks (a mesh of one rank, or None, reduces nothing)."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.size > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[DataMesh]:
    """The mesh of the enclosing :func:`data_parallel` block, if it has
    more than one rank; else None."""
    return _ACTIVE.get()


def _comm_device(t: torch.Tensor, mesh: DataMesh) -> torch.device:
    """Where ``t``'s collective runs: NCCL reduces on the card, gloo on the
    host (it takes CUDA tensors only for some collectives)."""
    if mesh.backend == 'nccl':
        return t.device if t.is_cuda else torch.device(
            'cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _collective(t: torch.Tensor, mesh: DataMesh, fn) -> torch.Tensor:
    """``fn(t)`` in place on ``t``, through a copy on the backend's device
    where ``t`` lies elsewhere; returns ``t``."""
    dev = _comm_device(t, mesh)
    if t.device == dev:
        fn(t)
        return t
    work = t.to(dev)
    fn(work)
    return t.copy_(work)


def all_reduce_(t: torch.Tensor, mesh: DataMesh,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the mesh's ranks, in place; returns ``t``."""
    if mesh.size <= 1:
        return t
    return _collective(t, mesh, lambda x: dist.all_reduce(
        x, op=op, group=mesh.group))


def broadcast_(t: torch.Tensor, mesh: DataMesh, src: int = 0
               ) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
    if mesh.size <= 1:
        return t
    return _collective(t, mesh, lambda x: dist.broadcast(
        x, src, group=mesh.group))


def _all_gather(t: torch.Tensor, mesh: DataMesh) -> list[torch.Tensor]:
    """Every rank's ``t`` (all of one shape), in rank order, on ``t``'s
    device."""
    src = t.detach().contiguous().to(_comm_device(t, mesh))
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return [p.to(t.device) for p in parts]


def all_gather_varlen(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's 1-D ``t``, of any lengths, concatenated in rank order
    on every rank."""
    if mesh.size <= 1:
        return t
    sizes = [int(n) for n in _all_gather(
        torch.tensor([t.numel()], dtype=torch.int64, device=t.device), mesh)]
    padded = torch.nn.functional.pad(t.reshape(-1),
                                     (0, max(sizes) - t.numel()))
    return torch.cat([p[:n] for p, n in zip(_all_gather(padded, mesh),
                                            sizes)])


class _SyncSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the gradients over the ranks
    (each rank's copy of the sum feeds its own share of the loss)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_(t.clone(memory_format=torch.contiguous_format),
                           mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format),
                           ctx.mesh), None


def sync_sum(t: torch.Tensor, mesh: Optional[DataMesh] = None
             ) -> torch.Tensor:
    """``t`` summed over the ranks of ``mesh`` (default: the active
    :func:`data_parallel` mesh), differentiably; ``t`` itself without one."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.size <= 1:
        return t
    return _SyncSum.apply(t, mesh)


def global_rows(b: int) -> int:
    """The global batch's rows when this rank holds ``b`` of them (every
    rank holds as many: the batch is padded to a multiple of the mesh)."""
    mesh = active_mesh()
    return b * mesh.size if mesh is not None else b


def first_row(b: int) -> int:
    """The global index of this rank's first row, of ``b`` per rank."""
    mesh = active_mesh()
    return b * mesh.rank if mesh is not None else 0


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def psum_tree(tree: Any, mesh: Optional[DataMesh] = None) -> Any:
    """Each tensor of ``tree`` summed over the mesh's ranks (a new tree; the
    integer counts stay exact). Without a mesh above one rank, ``tree``."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.size <= 1:
        return tree
    return _tree_map(lambda t: all_reduce_(t.detach().clone(), mesh)
                     if torch.is_tensor(t) else t, tree)


def pmean_tree(tree: Any, mesh: Optional[DataMesh] = None) -> Any:
    """Each tensor of ``tree`` averaged over the mesh's ranks."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.size <= 1:
        return tree
    return _tree_map(lambda t: t / mesh.size if torch.is_tensor(t) else t,
                     psum_tree(tree, mesh))


def all_gather_batch(x: torch.Tensor, mesh: Optional[DataMesh] = None
                     ) -> torch.Tensor:
    """Every rank's batch shard, concatenated in rank order on every rank
    (all shards of one shape)."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.size <= 1:
        return x
    return torch.cat(_all_gather(x, mesh))


# ---------------------------------------------------------------------------
# spatial tiling
# ---------------------------------------------------------------------------

def _halo_hw(halo) -> Tuple[int, int]:
    """A scalar halo, or a per-axis (halo_y, halo_x) pair."""
    if isinstance(halo, (tuple, list)):
        return int(halo[0]), int(halo[1])
    return int(halo), int(halo)


def tile_grid(height: int, width: int, tile_h: int, tile_w: int,
              halo) -> List[Tuple[int, int]]:
    """Top-left corners of the interior (core) tile grid, row-major."""
    return [(y, x) for y in range(0, height, tile_h)
            for x in range(0, width, tile_w)]


def _tile_origin(y: int, x: int, height: int, width: int, th: int,
                 tw: int, halo) -> Tuple[int, int]:
    """Top-left of the halo'd tile's slice, clamped inside the image.

    Clamping rather than padding keeps tiling exact through stacked
    zero-padded convolutions: each layer's padding then lies only at the
    image's true borders, as in the monolithic forward. A padded halo
    would be wrong: layer 1 makes nonzero values inside the halo where
    the monolithic layer 2 sees its own padding's zeros."""
    hy, hx = _halo_hw(halo)
    return (min(max(y - hy, 0), height - th),
            min(max(x - hx, 0), width - tw))


@dataclasses.dataclass(frozen=True)
class TileInfo:
    """The tile grid, threaded through a model's forward so that the
    globally coupled ops rebuild the full-image field from the tiles.

    Coordinates are at the input's resolution; ``scaled(k)`` divides them
    by a feature stride ``k``. ``origins`` holds, per tile, ``(y, x, sy,
    sx)``: the core's top-left and the clamped halo'd slice's. With a
    ``mesh`` above one rank, the tiles are spread over the ranks in order
    (each rank holds ``len(origins) / size`` consecutive tiles):
    ``assemble_full`` all-gathers them, and ``extract_tiles`` and
    ``resync`` return this rank's."""

    image_hw: Tuple[int, int]
    tile_hw: Tuple[int, int]
    halo: Tuple[int, int]
    origins: Tuple[Tuple[int, int, int, int], ...]
    mesh: Optional[DataMesh] = dataclasses.field(default=None,
                                                 compare=False)

    @classmethod
    def build(cls, image_hw, tile_hw, halo,
              mesh: Optional[DataMesh] = None) -> 'TileInfo':
        h, w = image_hw
        hy, hx = _halo_hw(halo)
        th, tw = tile_hw[0] + 2 * hy, tile_hw[1] + 2 * hx
        origins = tuple((y, x) + _tile_origin(y, x, h, w, th, tw, (hy, hx))
                        for y, x in tile_grid(h, w, tile_hw[0], tile_hw[1],
                                              (hy, hx)))
        return cls((h, w), tuple(tile_hw), (hy, hx), origins, mesh)

    def scaled(self, k: int) -> 'TileInfo':
        vals = [*self.image_hw, *self.tile_hw, *self.halo]
        vals += [v for o in self.origins for v in o]
        if any(v % k for v in vals):
            raise ValueError(
                f'tile geometry {self} not divisible by feature stride {k} '
                '— choose tile/halo sizes divisible by the deepest stride '
                '(32 for SegFormer-B0, 16 for DeepLabV3+)')
        return TileInfo(
            (self.image_hw[0] // k, self.image_hw[1] // k),
            (self.tile_hw[0] // k, self.tile_hw[1] // k),
            (self.halo[0] // k, self.halo[1] // k),
            tuple((y // k, x // k, sy // k, sx // k)
                  for (y, x, sy, sx) in self.origins), self.mesh)

    def scale_for(self, tile_shape_hw: Tuple[int, int]) -> int:
        """The feature stride of a halo'd tile's current spatial shape."""
        full = self.tile_hw[0] + 2 * self.halo[0]
        k, rem = divmod(full, tile_shape_hw[0])
        if rem or (self.tile_hw[1] + 2 * self.halo[1]) // k \
                != tile_shape_hw[1]:
            raise ValueError(
                f'tile shape {tile_shape_hw} does not evenly divide the '
                f'input tile {(full, self.tile_hw[1] + 2 * self.halo[1])}')
        return k

    @property
    def local(self) -> range:
        """The indices of this rank's tiles."""
        n = len(self.origins)
        size = self.mesh.size if self.mesh is not None else 1
        if n % size:
            raise ValueError(f'{n} tiles do not divide over {size} ranks')
        per = n // size
        rank = self.mesh.rank if self.mesh is not None else 0
        return range(rank * per, (rank + 1) * per)

    def resync(self, tiles: torch.Tensor) -> torch.Tensor:
        """Halo exchange: every tile's halo refilled with the other tiles'
        core values. Local ops between two resyncs consume the halo; a
        resync restores it, so tiling is exact while every segment's
        receptive radius stays within the halo."""
        return self.extract_tiles(self.assemble_full(tiles))

    def extract_tiles(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's halo'd tiles [n, th, tw, C] of a [1, H, W, C] full
        map at the same feature scale (the inverse of
        :meth:`assemble_full`)."""
        k = self.image_hw[0] // full.shape[1]
        info = self.scaled(k) if k > 1 else self
        th = info.tile_hw[0] + 2 * info.halo[0]
        tw = info.tile_hw[1] + 2 * info.halo[1]
        return torch.stack([full[0, sy:sy + th, sx:sx + tw, :]
                            for (_, _, sy, sx) in
                            (info.origins[i] for i in self.local)])

    def assemble_full(self, tiles: torch.Tensor) -> torch.Tensor:
        """This rank's halo'd tile features [n, th, tw, C] → the [1, H, W,
        C] full map, every rank's tiles gathered first: each tile's core
        (the cores partition the image) placed where it lies."""
        _, th, tw, c = tiles.shape
        k = self.scale_for((th, tw))
        info = self.scaled(k) if k > 1 else self
        if self.mesh is not None and self.mesh.size > 1:
            tiles = torch.cat(_all_gather(tiles, self.mesh))
        cth, ctw = info.tile_hw
        out = tiles.new_zeros((1, *info.image_hw, c))
        for i, (y, x, sy, sx) in enumerate(info.origins):
            oy, ox = y - sy, x - sx
            out[0, y:y + cth, x:x + ctw] = tiles[i, oy:oy + cth, ox:ox + ctw]
        return out


def spatial_tiles(image: torch.Tensor, tile_h: int, tile_w: int,
                  halo) -> torch.Tensor:
    """[H, W, C] → [N, tile_h + 2·halo_y, tile_w + 2·halo_x, C] tiles, each
    inside the image (edge tiles shift their halo inward,
    :func:`_tile_origin`). The tile size must divide the image and
    tile + 2·halo must fit in it."""
    h, w, _ = image.shape
    hy, hx = _halo_hw(halo)
    if h % tile_h or w % tile_w:
        raise ValueError(f'tile {tile_h}x{tile_w} does not divide the '
                         f'image {h}x{w}')
    th, tw = tile_h + 2 * hy, tile_w + 2 * hx
    if th > h or tw > w:
        raise ValueError(f'halo {halo} too large: tile+halo {th}x{tw} '
                         f'exceeds image {h}x{w}')
    return torch.stack([image[sy:sy + th, sx:sx + tw]
                        for sy, sx in (_tile_origin(y, x, h, w, th, tw, halo)
                                       for y, x in tile_grid(h, w, tile_h,
                                                             tile_w, halo))])


def stitch_tiles(tiles: torch.Tensor, height: int, width: int, tile_h: int,
                 tile_w: int, halo) -> torch.Tensor:
    """The inverse of :func:`spatial_tiles` for per-tile outputs [N, th,
    tw, C]: each tile's core, at its clamp-dependent offset, placed into
    [H, W, C]."""
    _, th, tw, c = tiles.shape
    out = tiles.new_zeros((height, width, c))
    for i, (y, x) in enumerate(tile_grid(height, width, tile_h, tile_w,
                                         halo)):
        sy, sx = _tile_origin(y, x, height, width, th, tw, halo)
        oy, ox = y - sy, x - sx
        out[y:y + tile_h, x:x + tile_w] = tiles[i, oy:oy + tile_h,
                                                ox:ox + tile_w]
    return out


def tiled_forward(apply_fn, variables, image: torch.Tensor, tile_h: int,
                  tile_w: int, halo, out_channels: int = 0,
                  mesh: Optional[DataMesh] = None,
                  with_tile_info: bool = False) -> Any:
    """``apply_fn`` over the spatial tiles of one [H, W, 3] image, its
    full-resolution outputs stitched back.

    The tiles form ``apply_fn``'s batch. With a ``mesh`` above one rank,
    each rank runs its share of them (the tile count must be a multiple of
    the mesh's size) and the outputs are all-gathered, so every rank
    returns the whole stitched result. ``apply_fn(variables, tiles)`` (or
    ``apply_fn(variables, tiles, tile_info)`` with ``with_tile_info``)
    returns a [n, th, tw, C] tensor or a dict of them; each is stitched."""
    h, w, _ = image.shape
    tiles = spatial_tiles(image, tile_h, tile_w, halo)
    info = TileInfo.build((h, w), (tile_h, tile_w), halo, mesh)
    local = info.local
    tiles = tiles[local.start:local.stop]
    out = (apply_fn(variables, tiles, info) if with_tile_info
           else apply_fn(variables, tiles))

    def stitch(v):
        if mesh is not None and mesh.size > 1:
            v = torch.cat(_all_gather(v, mesh))
        return stitch_tiles(v, h, w, tile_h, tile_w, halo)
    if isinstance(out, dict):
        return {k: stitch(v) for k, v in out.items()}
    return stitch(out)


def choose_tile_grid(height: int, width: int, n_tiles: int
                     ) -> Tuple[int, int]:
    """(tile_h, tile_w) splitting H×W into exactly ``n_tiles`` tiles, the
    most nearly square that divide both sides; raises if none does."""
    best = None
    for gh in range(1, n_tiles + 1):
        if n_tiles % gh:
            continue
        gw = n_tiles // gh
        if height % gh or width % gw:
            continue
        th, tw = height // gh, width // gw
        score = abs(th - tw)
        if best is None or score < best[0]:
            best = (score, th, tw)
    if best is None:
        raise ValueError(f'cannot split {height}x{width} into {n_tiles} tiles')
    return best[1], best[2]
