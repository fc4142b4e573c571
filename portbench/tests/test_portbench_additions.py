"""A configuration, a traffic mix, a cell and a metric added in a copy of
the benchmark are found by name, with no edit to a file already there."""

import json
import shutil

from portbench import harness


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
