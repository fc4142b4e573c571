"""One run of one cell: find its files by name, set up, measure, check.

Everything a cell is made of is found by the names in ``BENCHMARK.json``:
the workload's entry names its configuration (``configs/<config>.json``,
whose ``model.type`` names its adapter, ``models/<type>.py``) and its
traffic (``traffic/<traffic>.json``); the cell's own file
(``workloads/<name>.json``) names its driver (``drivers/<driver>.py``) and
holds the limits of its checks; each per-layer metric is a reader in
``metrics/<name>.py``. Adding a model type, a configuration, a mix, a cell
or a metric adds files and entries, and edits nothing but the
``workloads`` lists of the metrics the new cell reports.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Mapping

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (from
    ``/proc/self/stat``), or now where that cannot be read."""
    try:
        import os
        ticks = os.sysconf('SC_CLK_TCK')
        start = int(Path('/proc/self/stat').read_text().rsplit(')', 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path('/proc/uptime').read_text().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


def read_json(path: Path) -> Any:
    return json.loads(path.read_text())


def manifest(root: Path = ROOT) -> dict:
    return read_json(root / 'BENCHMARK.json')


def cell(name: str, bench: Mapping, here: Path = HERE) -> dict:
    """The cell ``name`` with its files read: ``entry`` (the manifest's),
    ``spec`` (workloads/<name>.json), ``config``, ``traffic``."""
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    return {'entry': entry,
            'spec': read_json(here / 'workloads' / f'{name}.json'),
            'config': read_json(here / 'configs' / f'{entry["config"]}.json'),
            'traffic': read_json(here / 'traffic'
                                 / f'{entry["traffic"]}.json')}


def driver(kind: str):
    """The driver module ``drivers/<kind>.py``."""
    return importlib.import_module(f'portbench.drivers.{kind}')


def reader(metric: str, here: Path = HERE):
    """The per-layer metric reader ``metrics/<metric>.py``'s ``read``."""
    path = here / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        f'portbench_metric_{metric.replace(".", "_").replace("-", "_")}',
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: Mapping, kind: str, name: str, e2e_names) -> list:
    """The manifest's metrics of ``kind`` ('end_to_end' or 'per_layer')
    that the cell ``name`` reports: those listing it, and those without a
    list (for per-layer ones, whose end-to-end metric the cell reports)."""
    out = []
    for m in bench[kind]:
        if 'workloads' in m:
            if name in m['workloads']:
                out.append(m)
        elif kind == 'end_to_end' or m['moves'] in e2e_names:
            out.append(m)
    return out


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = 'cuda', overrides: Mapping | None = None,
        started: float | None = None, bench: Mapping | None = None) -> dict:
    """One run; returns the result object (the last line's keys and
    ``checks``). ``overrides`` replaces traffic parameters (the CPU tests'
    small sizes); ``device`` 'cpu' is for those tests alone."""
    started = process_start() if started is None else started
    bench = manifest() if bench is None else bench
    c = cell(name, bench)
    traffic = dict(c['traffic'], **(overrides or {}))
    import torch
    from .common import guard
    if device == 'cuda':
        guard.require_cards(c['entry']['chips'])
    drv = driver(c['spec']['driver']).Driver(
        config=c['config'], traffic=traffic, seed=seed, device=device,
        traced=trace)
    drv.setup()
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        from .common.trace import WINDOW, Trace
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device == 'cuda' else [])
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                e2e = drv.window(iterations=traffic['trace_iterations'])
        trace_obj = Trace.from_profile(prof)
    else:
        setup_s = time.time() - started
        e2e = drv.window(seconds=seconds)
    cuda = device == 'cuda'
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = guard.forbidden_modules()
    if found:
        raise guard.ForbiddenImport(found)
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
           'count': c['entry']['chips'] if cuda else 0,
           'memory_peak_bytes': int(peak),
           'power_limit': guard.power_limit() if cuda else 'none'}
    e2e_names = [m['name'] for m in metrics_for(bench, 'end_to_end', name,
                                                ())]
    metrics = {}
    if trace:
        dev.update(busy_s=trace_obj.busy_s, window_s=trace_obj.window_s)
        ctx = drv.trace_context(trace_obj)
        for m in metrics_for(bench, 'per_layer', name, e2e_names):
            v = reader(m['name'])(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        e2e['setup_s'] = setup_s
        for m in metrics_for(bench, 'end_to_end', name, ()):
            if m['name'] in e2e:
                metrics[m['name']] = {'value': e2e[m['name']],
                                      'unit': m['unit']}
    attempted, failed = drv.attempted, drv.failed
    checks = drv.check(c['spec']['limits'])
    correct = failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    out = {'correct': correct, 'attempted': attempted, 'failed': failed,
           'metrics': metrics, 'device': dev}
    if trace:
        out['breakdown'] = trace_obj.breakdown()
    out['checks'] = {k: {'value': v, 'limit': lim}
                     for k, (v, lim) in checks.items()}
    for line in drv.notes:
        print(line, file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f'check {k}: {v!r} limit {lim!r}', file=sys.stderr)
    return out
