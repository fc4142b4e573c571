#!/usr/bin/env python3
"""The train CLI on a ``{data: d, model: m}`` mesh against the same CLI on
a ``{data: d}`` mesh and in one process, on the same config, seed and
synthetic data.

    python scripts/compare_mesh_cli.py --nproc 4 --mesh 2x2 --out runs/mesh

writes configs from ``configs/default.yaml`` (one epoch of the synthetic
set, no cached weights, ``--batch``, ``--hw``, ``--precision``), runs
``python -m awsegbench_torch.cli.train`` in one process, then under
``torch.distributed.run --nproc_per_node`` with ``tpu.mesh_shape: {data:
d}`` (d processes; skipped when d is 1) and with ``{data: d, model: m}``
(d·m processes; NCCL on cards, one card a rank; gloo with ``--device
cpu``), and prints one JSON line: each run's wall seconds and first
epoch's losses and mIoU, the relative differences of the model-axis run
from the data-axis run (the same rows load in each data rank: the model
axis's own effect) and of each run from one process, and the card's
``nvidia-smi`` name and power limit. A data rank loads only its rows of
each global batch, and the dataset draws its synthetic images and
weathers from one stateful stream in load order (as the JAX package's
does), so a mesh with a data axis above 1 trains on other synthetic
samples than one process.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import yaml

ROOT = Path(__file__).resolve().parent.parent
KEYS = ('train_loss', 'train_seg_loss', 'train_depth_loss', 'val_loss',
        'val_miou')


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return 'no nvidia-smi'


def write_config(out: Path, name: str, mesh, batch: int, hw,
                 precision: str) -> Path:
    cfg = yaml.safe_load((ROOT / 'configs' / 'default.yaml').read_text())
    cfg['model']['pretrained'] = False
    cfg['data'].update(data_root=str(out / 'no_data'), image_size=list(hw))
    cfg['training'].update(batch_size=batch, epochs=1, num_workers=2)
    cfg.setdefault('mlflow', {})['enabled'] = False
    cfg.setdefault('logging', {}).update(level='WARNING', progress_bar=False)
    cfg['tpu'].update(mesh_shape=mesh, precision=precision)
    path = out / f'config_{name}.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return path


def run(cmd, out: Path) -> tuple[float, dict]:
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=ROOT, check=True)
    seconds = time.perf_counter() - t0
    results = json.loads((out / 'results' / 'training_results.json')
                         .read_text())
    epoch = {**results['history']['train'][0], **results['history']['val'][0]}
    return seconds, {k: epoch[k] for k in KEYS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--nproc', type=int, default=4)
    p.add_argument('--mesh', default='2x2', help='dxm: data × model')
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--hw', default='512x1024')
    p.add_argument('--device', default='auto')
    p.add_argument('--precision', default='bf16', help="'bf16' or 'fp32'")
    p.add_argument('--out', default='runs/mesh_cli')
    args = p.parse_args(argv)
    d, m = (int(v) for v in args.mesh.split('x'))
    if d * m != args.nproc:
        raise SystemExit(f'--mesh {args.mesh} needs {d * m} processes')
    hw = [int(v) for v in args.hw.split('x')]
    out = Path(args.out).absolute()
    out.mkdir(parents=True, exist_ok=True)
    train = ['-m', 'awsegbench_torch.cli.train', '--device', args.device,
             '--seed', '0']
    meshes = {'one_process': ('auto', 1), 'data_axis': ({'data': d}, d),
              'model_axis': ({'data': d, 'model': m}, d * m)}
    if d == 1:
        del meshes['data_axis']
    runs = {}
    for name, (shape, nproc) in meshes.items():
        cfg = write_config(out, name, shape, args.batch, hw, args.precision)
        launch = [sys.executable] + (
            ['-m', 'torch.distributed.run', '--nproc_per_node', str(nproc)]
            if nproc > 1 else [])
        seconds, losses = run(launch + train + [
            '--config', str(cfg), '--output-dir', str(out / name)],
            out / name)
        runs[name] = {'nproc': nproc, 'mesh_shape': shape,
                      'wall_s': seconds, **losses}

    def rel(a, b):
        return {k: abs(runs[a][k] - runs[b][k]) / max(abs(runs[b][k]),
                                                       1e-12)
                for k in KEYS}
    base = 'data_axis' if 'data_axis' in runs else 'one_process'
    print(json.dumps({
        'nvidia_smi': nvidia_smi(), 'batch': args.batch, 'hw': hw,
        'precision': args.precision, 'runs': runs,
        'rel_diff_model_axis_vs_' + base: rel('model_axis', base),
        'rel_diff_vs_one_process': {n: rel(n, 'one_process')
                                    for n in runs if n != 'one_process'}}),
        flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
