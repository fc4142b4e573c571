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

import io
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


# ---------------------------------------------------------------------------
# tensor parallelism: jobs on a {data: d, model: m} mesh
# ---------------------------------------------------------------------------

def _leaf_flops(model, run) -> dict:
    """``run()``'s FLOPs by leaf conv and linear module (by name)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        run()
    counts = counter.get_flop_counts()
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            key = next((k for k in counts if k.endswith('.' + name)), None)
            out[name] = sum(counts[key].values()) if key else 0
    return out


def tp_forward_job(payload) -> dict:
    """The narrow ensemble's eval forward on the payload's ``shape`` mesh,
    its parameters sharded at ``tp_min_features``: its outputs, the
    unsharded forward's on this rank, each leaf conv and linear layer's
    FLOPs in both, the layout and the mesh's place of this rank."""
    from awsegbench_torch.core.mesh import create_mesh, tp_param_shardings
    from awsegbench_torch.parallel.tensor import shard_model_
    model = narrow_ensemble(payload['num_classes'],
                            payload['include_depth']).eval()
    model.load_state_dict(payload['state'])
    x = payload['x']
    with torch.no_grad():
        ref = model(x)
        flops_ref = _leaf_flops(model, lambda: model(x))
    mesh = create_mesh(mesh_shape=payload['shape'])
    layout = tp_param_shardings(model, mesh, payload['tp_min_features'])
    shard_model_(model, mesh, layout)
    with torch.no_grad():
        out = model(x)
        flops = _leaf_flops(model, lambda: model(x))
    return {'out': out, 'ref': ref, 'flops': flops, 'flops_ref': flops_ref,
            'layout': layout, 'rank': mesh.rank,
            'data': (mesh.data.rank, mesh.data.size),
            'model': (mesh.model.rank, mesh.model.size),
            'local_shapes': {n: tuple(p.shape)
                             for n, p in model.named_parameters()}}


def tp_step_job(payload) -> dict:
    """One ``TrainStep`` (f32, AdamW, the payload's clip; the MiT blocks
    rematerialised with ``remat``) of the narrow ensemble with depth heads
    on the payload's ``shape`` mesh: the losses, this rank's gradients and
    updated parameters (slices where sharded), BN buffers, AdamW's state
    shapes and ``opt_state_shardings``, the parameter, gradient and moment
    bytes this rank holds."""
    from awsegbench_torch.core.mesh import (create_mesh, opt_state_shardings,
                                            tp_param_shardings)
    from awsegbench_torch.parallel.tensor import full_state_dict
    from awsegbench_torch.train.optim import create_optimizer
    from awsegbench_torch.train.step import TrainStep
    model = narrow_ensemble(payload['num_classes'], True)
    model.load_state_dict(payload['state'])
    model.segformer.MiTEncoder_0.remat = payload.get('remat', False)
    mesh = create_mesh(mesh_shape=payload['shape'])
    names = [n for n, _ in model.named_parameters()]
    optimizer = create_optimizer(model.parameters(), payload['optimizer'],
                                 grad_clip=payload['grad_clip'])
    step = TrainStep(model, optimizer, precision='fp32', device='cpu',
                     mesh=mesh, tp_min_features=payload['tp_min_features'])
    layout = tp_param_shardings(narrow_ensemble(payload['num_classes'],
                                                True), mesh,
                                payload['tp_min_features'])
    loss = step(*payload['batch'], draws=payload['draws'])
    params = dict(model.named_parameters())
    inner = optimizer.inner
    state = {n: {k: tuple(v.shape) for k, v in inner.state[p].items()}
             for n, p in params.items()}

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    return {'loss': {k: v.clone() for k, v in loss.items()},
            'grads': {n: p.grad.clone() for n, p in params.items()},
            'params': {n: p.detach().clone() for n, p in params.items()},
            'buffers': {n: b.clone() for n, b in model.named_buffers()},
            'layout': layout, 'state_shapes': state,
            'opt_layout': opt_state_shardings(inner, layout, names),
            'full': full_state_dict(model),
            'bytes': {'params': nbytes(params.values()),
                      'grads': nbytes(p.grad for p in params.values()),
                      'moments': nbytes(v for st in inner.state.values()
                                        for v in st.values() if v.ndim)},
            'rank': mesh.rank, 'data': (mesh.data.rank, mesh.data.size),
            'model': (mesh.model.rank, mesh.model.size)}


def tp_trainer(payload, checkpoint_dir):
    """An ``AdverseWeatherTrainer`` of the narrow ensemble (depth heads)
    with the payload's config (its ``tpu.mesh_shape``) and loaders, on
    the CPU."""
    from awsegbench_torch.train.trainer import AdverseWeatherTrainer
    model = narrow_ensemble(payload['num_classes'], True)
    model.load_state_dict(payload['state'])
    d = Path(checkpoint_dir)
    return AdverseWeatherTrainer(model, payload['train'], payload['val'],
                                 payload['config'], device='cpu',
                                 checkpoint_dir=str(d / 'c'),
                                 log_dir=str(d / 'l'))


def tp_trainer_job(payload) -> dict:
    """On a {data: 2, model: 2} mesh: one train epoch and one validation
    of the trainer (their metrics and the full state after them);
    ``EarlyStopping``'s snapshot and restore of the sharded model; another
    epoch after the restore; the ``Evaluator`` sweep of the payload's
    ``sweep`` on the same mesh."""
    from awsegbench_torch.parallel.tensor import full_state_dict, shard_of
    from awsegbench_torch.train.trainer import EarlyStopping
    rank = dist.get_rank()
    trainer = tp_trainer(payload, Path(payload['dir']) / f'rank{rank}')
    out = {'train': trainer.train_epoch(), 'val': trainer.validate_epoch(),
           'mesh': trainer.mesh.shape, 'is_main': trainer.is_main}
    out['full'] = {k: v.clone() for k, v in
                   full_state_dict(trainer.model).items()}
    model = trainer.model
    shapes = {n: p.shape for n, p in model.named_parameters()}
    es = EarlyStopping(patience=1, min_delta=0.0)
    stops = [es(1.0, model)[0]]
    best = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    stop, restored = es(2.0, model)
    stops.append(stop)
    out['restore'] = {
        'stops': stops, 'same_model': restored is model,
        'equal': all(torch.equal(v, restored.state_dict()[k])
                     for k, v in best.items()),
        'shapes_kept': all(p.shape == shapes[n]
                           for n, p in restored.named_parameters()),
        'sharded': sorted(n for n, p in restored.named_parameters()
                          if shard_of(p) is not None)}
    out['after_restore'] = trainer.train_epoch()
    out['sweep'] = sweep_job(payload['sweep'], trainer.mesh)
    return out


def _saved(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def tp_checkpoint_job(payload) -> dict:
    """On a {data: 1, model: 2} mesh: a train epoch and a checkpoint
    written by world rank 0 (the full state dict and optimiser state it
    gathered), then a one-process checkpoint loaded (this rank's
    parameters and optimiser state); then ``cli_job`` on the payload's
    ``cli``."""
    from awsegbench_torch.parallel.tensor import full_state_dict
    rank = dist.get_rank()
    trainer = tp_trainer(payload, payload['dir'] if rank == 0 else
                         Path(payload['dir']) / f'rank{rank}')
    trainer.train_epoch()
    trainer.save_checkpoint(0, {'val_miou': 0.5}, is_best=False)
    out = torch.load(io.BytesIO(_saved({
        'full': full_state_dict(trainer.model),
        'full_optimizer': trainer.optimizer.state_dict()})),
        weights_only=False)             # copies, before the load below
    trainer.load_checkpoint(payload['one_checkpoint'])
    out['loaded'] = {k: v.clone() for k, v in
                     trainer.model.state_dict().items()}
    out['loaded_optimizer'] = trainer.optimizer.inner.state_dict()
    out['epoch'], out['rank'] = trainer.current_epoch, rank
    out['cli'] = cli_job(payload['cli'])
    return out


JOBS = {'train': train_job, 'sweep': sweep_job, 'tiles': tiles_job,
        'collectives': collectives_job, 'cli': cli_job,
        'tp_forward': tp_forward_job, 'tp_step': tp_step_job,
        'tp_trainer': tp_trainer_job, 'tp_checkpoint': tp_checkpoint_job}
