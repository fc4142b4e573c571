"""A configuration, a traffic mix, a cell and a metric added in a copy of
the benchmark are found by name, with no edit to a file already there; and
a model type other than the ensemble (the factory's single SegFormer and
DeepLabV3+) is added by files and manifest entries alone, runs whole from
the copy, and passes the copy's own tests of configurations, manifest and
imports."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import single_configs

SWEEP_LIMITS = harness.read_json(harness.HERE / 'workloads'
                                 / 'sweep-b0r50-mixed.json')['limits']
# each added single-model type: its cell, and the per-layer metrics of the
# sweep that find something to read in it
ADDED = {
    'segformer-b0': ('sweep-b0-mixed', (
        'sweep.metrics_ms', 'sweep.segformer_ms', 'k1.roofline.sweep',
        'k2.roofline.sweep', 'mfu.sweep', 'idle.sweep', 'sweep.prepare_ms',
        'sweep.confusion_ms', 'sweep.ece_ms', 'sweep.host_ms',
        'sweep.launches')),
    'deeplabv3plus-r50': ('sweep-r50-mixed', (
        'sweep.metrics_ms', 'sweep.deeplab_ms', 'mfu.sweep', 'idle.sweep',
        'sweep.prepare_ms', 'sweep.confusion_ms', 'sweep.ece_ms',
        'sweep.host_ms', 'sweep.launches')),
}
SWEEP_FAULTS = harness.driver('sweep').FAULTS
# the copy's own tests that read every configuration, cell and source
COPY_TESTS = ('test_portbench_configs.py', 'test_portbench_manifest.py',
              'test_portbench_imports.py')


def copy_benchmark(root):
    """``BENCHMARK.json`` and ``portbench/`` copied under ``root``; returns
    the bytes of every file copied."""
    shutil.copytree(harness.HERE, root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'cache'))
    shutil.copy(harness.ROOT / 'BENCHMARK.json', root / 'BENCHMARK.json')
    return {p: p.read_bytes() for p in root.rglob('*') if p.is_file()}


def test_addition_needs_no_edit(tmp_path):
    here = tmp_path / 'portbench'
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns('__pycache__', 'cache'))
    before = {p: p.read_bytes() for p in here.rglob('*') if p.is_file()}
    bench = harness.manifest()
    cfg = json.loads((here / 'configs' / 'ensemble-b0-r50.json').read_text())
    cfg['name'] = 'ensemble-b1-r50'
    cfg['model']['segformer_variant'] = 'b1'
    (here / 'configs' / 'ensemble-b1-r50.json').write_text(json.dumps(cfg))
    (here / 'traffic' / 'sweep-clean.json').write_text(json.dumps(
        dict(json.loads((here / 'traffic' / 'sweep-mixed.json')
                        .read_text()), weathers='clean')))
    (here / 'workloads' / 'sweep-b1r50-clean.json').write_text(json.dumps(
        {'driver': 'sweep', 'why': 'a control without corruption',
         'limits': {'cm_moved': 0.1}}))
    (here / 'metrics' / 'sweep.images_counted.py').write_text(
        'def read(ctx):\n    return float(ctx["units"])\n')
    bench['configs'].append({'name': 'ensemble-b1-r50', 'source': 'x',
                             'file': 'portbench/configs/ensemble-b1-r50.json',
                             'reduced': [], 'why': 'x'})
    bench['workloads'].append({'name': 'sweep-b1r50-clean',
                               'config': 'ensemble-b1-r50',
                               'traffic': 'sweep-clean', 'chips': 1,
                               'why': 'x'})
    bench['per_layer'].append({'name': 'sweep.images_counted', 'unit': 'n',
                               'better': 'higher',
                               'source': 'program_counter',
                               'layer': 'sweep', 'moves': 'setup_s',
                               'workloads': ['sweep-b1r50-clean']})
    c = harness.cell('sweep-b1r50-clean', bench, here)
    assert c['config']['model']['segformer_variant'] == 'b1'
    assert c['traffic']['weathers'] == 'clean'
    assert c['spec']['driver'] == 'sweep'
    per_layer = harness.metrics_for(bench, 'per_layer', 'sweep-b1r50-clean',
                                    ['setup_s'])
    assert [m['name'] for m in per_layer] == ['sweep.images_counted']
    assert harness.reader('sweep.images_counted', here)({'units': 8}) == 8.0
    after = {p: p.read_bytes() for p in here.rglob('*') if p.is_file()
             and p in before}
    assert after == before


def add_type(root, name):
    """Adds the single-model configuration ``name`` and its sweep cell to
    the copy at ``root`` as a later change would: its configuration file,
    its cell file, the manifest's entries for both, and the cell appended
    to the ``workloads`` of ``sweep_images_per_s`` and of the per-layer
    metrics that read it. Returns the manifest before and after."""
    cell, per_layer = ADDED[name]
    config = single_configs()[name]
    here = root / 'portbench'
    (here / 'configs' / f'{name}.json').write_text(json.dumps(config))
    (here / 'workloads' / f'{cell}.json').write_text(json.dumps(
        {'config': name, 'traffic': 'sweep-mixed', 'driver': 'sweep',
         'why': f'{name} alone in the sweep', 'limits': SWEEP_LIMITS}))
    before = json.loads((root / 'BENCHMARK.json').read_text())
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': name, 'source': config['source'],
                             'file': f'portbench/configs/{name}.json',
                             'reduced': [], 'why': f'{name} alone'})
    bench['workloads'].append({'name': cell, 'config': name,
                               'traffic': 'sweep-mixed', 'chips': 1,
                               'why': f'{name} alone in the sweep'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if m['name'] in ('sweep_images_per_s',) + per_layer:
            m['workloads'].append(cell)
    (root / 'BENCHMARK.json').write_text(json.dumps(bench, indent=1))
    return before, bench


# the run in the copy: its own harness, drivers and adapters, found first
# on the path; the port from the repository
RUN = '''
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from portbench import faults, harness
from portbench.tests.conftest import TINY
assert str(harness.HERE).startswith(sys.argv[1]), harness.HERE
cell = sys.argv[3]
bench = harness.manifest()
c = harness.cell(cell, bench)
drv = harness.driver(c['spec']['driver'])


def run(seed, trace=False):
    return harness.run(cell, seed, 0.5, trace, device='cpu',
                       overrides=dict(TINY, precision='fp32'), bench=bench)


out = {'f32': run(5), 'traced': run(11, trace=True),
       'control': drv.Driver(config=c['config'],
                             traffic=dict(c['traffic'], **TINY), seed=9,
                             device='cpu', traced=False).control(),
       'limits': c['spec']['limits'], 'faults': {}}
for fault in drv.FAULTS:
    with faults.planted(fault, c['config']):
        out['faults'][fault] = run(5)
print(json.dumps(out))
'''


@pytest.fixture(scope='module', params=sorted(ADDED))
def added(request, tmp_path_factory):
    """The single-model type ``request.param`` added to a copy and its cell
    run there on the CPU at ``TINY``: in f32, traced, the control and each
    of the sweep driver's faults."""
    root = tmp_path_factory.mktemp(request.param)
    files = copy_benchmark(root)
    before, bench = add_type(root, request.param)
    cell = ADDED[request.param][0]
    proc = subprocess.run([sys.executable, '-c', RUN, str(root),
                           str(harness.ROOT), cell], capture_output=True,
                          text=True, cwd=root, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {'root': root, 'files': files, 'before': before, 'bench': bench,
            'cell': cell, 'name': request.param,
            'out': json.loads(proc.stdout.strip().splitlines()[-1])}


def test_added_type_edits_no_file(added):
    """Every file that was there is byte-equal, but for the manifest, which
    differs by the added entries and the cell appended to the metrics'
    ``workloads`` alone."""
    root = added['root']
    manifest = root / 'BENCHMARK.json'
    assert all(p.read_bytes() == b for p, b in added['files'].items()
               if p != manifest)
    before, after = added['before'], json.loads(manifest.read_text())
    cell, per_layer = ADDED[added['name']]
    for key in ('configs', 'workloads'):
        assert after[key][:-1] == before[key]
    for key in ('end_to_end', 'per_layer'):
        assert len(after[key]) == len(before[key])
        for old, new in zip(before[key], after[key]):
            if new['name'] in ('sweep_images_per_s',) + per_layer:
                assert new == dict(old, workloads=old['workloads'] + [cell])
            else:
                assert new == old
    assert {k: v for k, v in after.items() if k not in (
        'configs', 'workloads', 'end_to_end', 'per_layer')} == {
        k: v for k, v in before.items() if k not in (
            'configs', 'workloads', 'end_to_end', 'per_layer')}


def test_added_type_passes_the_copys_own_tests(added):
    """The copy's own tests, run from the copy, hold the added configuration
    and cell (sizes, manifest entries, imports) with no edit to them."""
    root, cell = added['root'], added['cell']
    proc = subprocess.run(
        [sys.executable, '-m', 'pytest', '-v', '-p', 'no:cacheprovider',
         *(f'portbench/tests/{t}' for t in COPY_TESTS)],
        capture_output=True, text=True, cwd=root, timeout=1200,
        env=dict(os.environ, PYTHONPATH=str(harness.ROOT)))
    assert proc.returncode == 0, proc.stdout[-4000:]
    passed = [line for line in proc.stdout.splitlines()
              if line.endswith('PASSED') or ' PASSED ' in line]
    assert any(f'test_cell_resolves[{cell}]' in line for line in passed)
    assert any(f'test_config_resolves[{added["name"]}]' in line
               for line in passed)
    assert any(f'test_config_sizes_are_the_built_model[{added["name"]}'
               in line for line in passed)


def test_added_type_agrees_in_f32(added):
    """In f32 the port's single model and the reference's compute the same
    function: every number at or under a twentieth of its limit."""
    out = added['out']['f32']
    assert out['correct'] and out['failed'] == 0 and out['attempted'] > 0
    for name, c in out['checks'].items():
        assert c['value'] <= c['limit'] / 20, (name, c)
    assert set(out['metrics']) == {'sweep_images_per_s', 'setup_s'}


def test_added_type_traced_reads_its_metrics(added):
    """A traced run is correct and reads the per-layer metrics listed for
    the cell (the span readers find no device operations on the CPU);
    ``mfu.sweep`` divides the adapter's FLOPs."""
    from portbench.counts.flops import forward_flops
    from portbench.counts.roofline import BF16_PEAK
    from portbench.tests.conftest import TINY
    out = added['out']['traced']
    assert out['correct']
    assert set(out['metrics']) <= set(ADDED[added['name']][1])
    mfu = out['metrics']['mfu.sweep']['value']
    config = single_configs()[added['name']]
    want = (100.0 * forward_flops(config, TINY['height'], TINY['width'])
            * out['attempted'] / (out['device']['window_s'] * BF16_PEAK))
    assert mfu == pytest.approx(want, rel=1e-9)


def test_added_type_control_is_not_correct(added):
    numbers, limits = added['out']['control'], added['out']['limits']
    assert any(not numbers[k] <= v for k, v in limits.items()
               if k in numbers), numbers


@pytest.mark.parametrize('fault', SWEEP_FAULTS)
def test_added_type_fault_is_not_correct(added, fault):
    out = added['out']['faults'][fault]
    assert not out['correct'], (fault, out['checks'])
