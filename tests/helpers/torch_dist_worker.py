"""Two-rank jobs of the port (``awsegbench_torch``) over gloo on the CPU,
for tests/test_torch_distributed.py.

:func:`spawn` starts one process per rank (``torch.multiprocessing``'s
spawn context, a free localhost port), each of which runs :func:`run`:
it joins the process group (``core.mesh.init_distributed``, gloo), runs
the named job on the payload the parent saved, saves the job's result
for the parent, and leaves the group. A rank that fails, or a pair that
does not finish within the timeout, fails the call (hung ranks are
killed). This module imports torch and the port only: the spawned ranks
never import JAX.
"""

from __future__ import annotations

import os
import socket
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def narrow_ensemble(num_classes: int = 5, include_depth: bool = False):
    """The port's ensemble with the JAX tests' narrow members
    (``tests/test_eval.py::_TinyEnsemble``): MiT widths (8, 16, 20, 32),
    one block a stage; ResNet widths (8, 12, 16, 24), one bottleneck a
    stage."""
    from awsegbench_torch.models.deeplab import DeepLabV3PlusModel
    from awsegbench_torch.models.ensemble import EnsembleModel
    from awsegbench_torch.models.segformer import SegFormerModel
    model = EnsembleModel(num_classes, include_depth, head_mode='faithful')
    model.segformer = SegFormerModel(num_classes, include_depth, 'faithful',
                                     hidden_sizes=(8, 16, 20, 32),
                                     depths=(1, 1, 1, 1))
    model.deeplabv3plus = DeepLabV3PlusModel(
        num_classes, include_depth, encoder_layers=(1, 1, 1, 1),
        encoder_widths=(8, 12, 16, 24))
    return model


class ToyDataset:
    """A map-style dataset of ``n`` 4×4 items whose pixels hold their
    index (the loader's process slicing is read off the batches)."""

    def __init__(self, n: int) -> None:
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        return {'image': np.full((4, 4, 3), i, np.uint8),
                'label': np.full((4, 4), i % 5, np.int32),
                'weather_id': i % 5, 'weather_condition': 'clean'}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def spawn(job: str, payload, tmp: Path, world: int = 2,
          timeout: float = 110.0) -> list:
    """Runs ``job`` on ``payload`` in ``world`` spawned ranks; returns each
    rank's result, in rank order."""
    import torch.multiprocessing as mp
    tmp.mkdir(parents=True, exist_ok=True)
    inp, out = tmp / f'{job}.in', tmp / f'{job}.out'
    torch.save(payload, inp)
    ctx = mp.get_context('spawn')
    port = free_port()
    procs = [ctx.Process(target=run, args=(r, world, port, job, str(inp),
                                           str(out)), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f'{job}: {len(hung)} rank(s) still running after ' \
                     f'{timeout} s'
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f'{job}: rank exit codes {codes}'
    return [torch.load(f'{out}.{r}', weights_only=False)
            for r in range(world)]


def run(rank: int, world: int, port: int, job: str, inp: str,
        out: str) -> None:
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from awsegbench_torch.core.mesh import init_distributed
    init_distributed(f'localhost:{port}', world, rank, backend='gloo')
    try:
        payload = torch.load(inp, weights_only=False)
        result = JOBS[job](payload)
        torch.save(result, f'{out}.{rank}')
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# jobs: each returns what the parent compares
# ---------------------------------------------------------------------------

def train_job(payload) -> list:
    """One train step per case: (loss dict, gradients by name, BN buffers
    by name). A case is a dict with the model's ``state`` (narrow
    ensemble), ``include_depth``, ``dtype`` ('float32' or 'float64'), the
    global ``batch`` (images, labels, weather ids), its ``draws`` and an
    optional ``sample_mask``."""
    return [train_case(case) for case in payload]


def train_case(case, mesh=None):
    """One step of ``TrainStep`` (plain SGD at lr 0, no clip: the raw
    gradients stay in ``.grad``) on ``mesh`` (default: the world); f64
    runs the model and the step's forward in f64."""
    from awsegbench_torch.core.precision import Policy
    from awsegbench_torch.train.optim import create_optimizer
    from awsegbench_torch.train.step import TrainStep
    model = narrow_ensemble(case.get('num_classes', 5),
                            case['include_depth'])
    model.load_state_dict(case['state'])
    sgd0 = {'type': 'sgd', 'learning_rate': 0.0, 'momentum': 0.0,
            'weight_decay': 0.0}
    step = TrainStep(model, create_optimizer(model.parameters(), sgd0,
                                             grad_clip=0.0),
                     precision='fp32', device='cpu', mesh=mesh)
    if case['dtype'] == 'float64':
        model.double()
        step.policy = Policy(torch.float64, torch.float64)
    t0 = time.perf_counter()
    loss = step(*case['batch'], draws=case['draws'],
                sample_mask=case.get('sample_mask'))
    seconds = time.perf_counter() - t0
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).clone()
             for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    return ({k: v.clone() for k, v in loss.items()}, grads, buffers,
            seconds)


def sweep_job(payload, mesh=None) -> dict:
    """The ``Evaluator`` sweep in each of the payload's configs (AUROC
    modes, spatial tiling) on ``mesh`` (default: the world): results and
    accumulators."""
    from awsegbench_torch.eval.evaluator import Evaluator
    out = {}
    for name, cfg in payload['configs'].items():
        model = narrow_ensemble(payload['num_classes'])
        model.load_state_dict(payload['state'])
        ev = Evaluator(model, cfg, device='cpu', mesh=mesh)
        res = ev.run(payload['batches'], draws=payload.get('draws'))
        out[name] = (res, ev.last_acc)
    return out


def tiles_job(payload, mesh=None) -> dict:
    """``tiled_forward`` of the narrow ensemble with its tiles spread over
    ``mesh``'s ranks (default: the world), exact (``tile_info``)."""
    from awsegbench_torch.core.mesh import create_mesh
    from awsegbench_torch.parallel.collectives import tiled_forward
    model = narrow_ensemble(payload['num_classes'],
                            payload['include_depth']).eval()
    model.load_state_dict(payload['state'])
    mesh = create_mesh() if mesh is None else mesh
    img = payload['image']
    th, tw, halo = payload['tile']
    with torch.no_grad():
        tiled = tiled_forward(
            lambda _, t, info: model(t, tile_info=info), None, img, th, tw,
            halo, mesh=mesh, with_tile_info=True)
    return {'tiled': tiled, 'rank': mesh.rank, 'size': mesh.size}


def collectives_job(payload) -> dict:
    """Every collective, the mesh, the loader's process slicing, the
    exact sharded AUROC and a halo resync over the ranks; each rank's
    inputs depend on its rank."""
    from awsegbench_torch.core.mesh import (create_mesh, replicate,
                                            shard_batch)
    from awsegbench_torch.data.pipeline import create_dataloader
    from awsegbench_torch.metrics.disagreement import auroc_exact_sharded
    from awsegbench_torch.parallel import collectives as col
    mesh = create_mesh()
    r = mesh.rank
    res = {'rank': r, 'size': mesh.size,
           'mesh_dict': create_mesh(mesh_shape={'data': 2}).size}
    for bad in ({'data': 1}, {'data': 4}):
        try:
            create_mesh(mesh_shape=bad)
            res[f'mesh_{bad["data"]}'] = 'accepted'
        except ValueError as e:
            res[f'mesh_{bad["data"]}'] = str(e)
    tree = {'i': torch.arange(4, dtype=torch.int64) * (r + 1),
            'f': torch.full((2, 3), float(r + 1), dtype=torch.float64)}
    res['psum'] = col.psum_tree(tree, mesh)
    res['pmean'] = col.pmean_tree(tree, mesh)
    res['gather'] = col.all_gather_batch(torch.full((2, 2), float(r)), mesh)
    res['varlen'] = col.all_gather_varlen(torch.arange(r + 2.0), mesh)
    # sync_sum: each rank's share of a global loss; the gradients sum to
    # the global one
    x = torch.tensor([1.0, 2.0, 3.0]) * (r + 1)
    x.requires_grad_(True)
    with col.data_parallel(mesh):
        s = col.sync_sum((x * x).sum())
        res['rows'] = (col.global_rows(3), col.first_row(3))
    (s * s / mesh.size).backward()
    res['sync_value'], res['sync_grad'] = s.detach(), x.grad.clone()
    # replicate: rank 0's values everywhere
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(r + 7))
    replicate(lin, mesh)
    res['replicated'] = lin.weight.detach().clone()
    res['shard'] = shard_batch({'a': np.arange(8)}, mesh)['a']
    # the loader reads the group
    loader = create_dataloader(payload['dataset'], batch_size=4,
                               shuffle=True, num_workers=1, seed=3)
    res['loader'] = ((loader.process_index, loader.process_count),
                     [b['sample_id'].tolist() for b in loader])
    # the fog-density-aware loss with fog from the predicted depth: every
    # mean, and the depth's min, max and edge mean, over the global batch
    res['loss'] = loss_case(payload['loss'], mesh)
    g = torch.Generator().manual_seed(11 + r)
    n = 50 + 17 * r
    scores = torch.rand(n, generator=g).round(decimals=2)
    labels = (torch.rand(n, generator=g) < 0.4).float()
    weights = (torch.rand(n, generator=g) < 0.9).float()
    res['auroc'] = (scores, labels, weights,
                    auroc_exact_sharded(scores, labels, weights, mesh))
    # a halo resync with the tiles split over the ranks
    from awsegbench_torch.parallel.collectives import TileInfo, spatial_tiles
    img = payload['image']
    info = TileInfo.build(img.shape[:2], (32, 32), 8, mesh)
    tiles = spatial_tiles(img, 32, 32, 8)[info.local.start:info.local.stop]
    res['resync'] = info.resync(torch.where(payload['core'][
        info.local.start:info.local.stop], tiles, 999.0))
    return res


def loss_case(inputs, mesh=None):
    """``FogDensityAwareLoss`` with no fog density given (fog from the
    predicted depth) on this rank's rows of ``inputs``: the loss and the
    gradients of its share ``total / world`` on the predictions."""
    from awsegbench_torch.core.mesh import DataMesh, mesh_rows
    from awsegbench_torch.losses.fog_density import FogDensityAwareLoss
    from awsegbench_torch.parallel.collectives import data_parallel
    mesh = mesh if mesh is not None else DataMesh()
    rows = mesh_rows(mesh, inputs['seg'].shape[0])
    seg = inputs['seg'][rows].clone().requires_grad_(True)
    depth = inputs['depth'][rows].clone().requires_grad_(True)
    with data_parallel(mesh):
        loss = FogDensityAwareLoss()(
            {'segmentation': seg, 'depth': depth},
            {'label': inputs['label'][rows],
             'depth': inputs['target'][rows]},
            None, inputs['mask'][rows])
    (loss['total_loss'] / mesh.size).backward()
    return ({k: v.detach() for k, v in loss.items()}, seg.grad, depth.grad)


def cli_job(payload) -> dict:
    """The train CLI in this rank as torchrun would start it (the
    environment names the rank, the world and the address), then the
    evaluate CLI on its latest checkpoint."""
    rank, world = dist.get_rank(), dist.get_world_size()
    addr = payload['port']
    dist.destroy_process_group()        # the CLI joins its own group
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR='localhost',
                      MASTER_PORT=str(addr))
    from awsegbench_torch.cli import evaluate as ecli
    from awsegbench_torch.cli import train as tcli
    out = payload['out']
    trainer = tcli.main(['--config', payload['config'], '--output-dir', out,
                         '--device', 'cpu'])
    res = {'rank': trainer.mesh.rank, 'size': trainer.mesh.size,
           'state': {k: v.clone() for k, v in
                     trainer.model.state_dict().items()},
           'train_loader': (trainer.train_loader.process_index,
                            trainer.train_loader.process_count)}
    os.environ['MASTER_PORT'] = str(payload['port2'])
    res['eval'] = ecli.main([f'{out}/checkpoints/latest', '--config',
                             payload['config'], '--output-dir',
                             f'{out}/eval', '--device', 'cpu'])
    return res


JOBS = {'train': train_job, 'sweep': sweep_job, 'tiles': tiles_job,
        'collectives': collectives_job, 'cli': cli_job}
