"""BENCHMARK.json against the contract: every name resolves to its file,
and names, units and limits keep to their forms."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
BENCH = harness.manifest()


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['portbench']
    assert BENCH['command'] == ['python3', 'portbench/run.py']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('w', BENCH['workloads'], ids=lambda w: w['name'])
def test_cell_resolves(w):
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(w['name']) and NAME.match(w['traffic'])
    assert w['chips'] == 1 and 1 <= len(w['why']) <= 200
    c = harness.cell(w['name'], BENCH)
    assert (c['spec']['config'], c['spec']['traffic']) == (w['config'],
                                                          w['traffic'])
    assert c['spec']['driver'] in ('sweep', 'train', 'serve')
    harness.driver(c['spec']['driver']).Driver
    assert c['config']['name'] == w['config']
    assert set(c['spec']['limits']) and all(
        v >= 0 for v in c["spec"]["limits"].values())


@pytest.mark.parametrize('c', BENCH['configs'], ids=lambda c: c['name'])
def test_config_resolves(c):
    assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(c['name']) and all(NAME.match(k) for k in c['reduced'])
    path = harness.ROOT / c['file']
    assert c['file'].startswith('portbench/configs/') and path.exists()
    data = json.loads(path.read_text())
    assert data['reduced'] == c['reduced']
    assert 1 <= len(c['source']) <= 200
    assert any(w['config'] == c['name'] for w in BENCH['workloads'])


def test_metrics_resolve():
    names = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(names) == len(set(names))
    cells = {w['name'] for w in BENCH['workloads']}
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in BENCH['end_to_end']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
        assert set(m.get('workloads', cells)) <= cells
    for m in BENCH['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['moves'] in e2e and '\n' not in m['layer']
        assert set(m['workloads']) <= cells
        assert callable(harness.reader(m['name']))
        for w in m['workloads']:
            assert w in e2e[m['moves']].get('workloads', cells)


@pytest.mark.parametrize('w', BENCH['workloads'], ids=lambda w: w['name'])
def test_every_cell_reports_enough(w):
    e2e = harness.metrics_for(BENCH, 'end_to_end', w['name'], ())
    names = [m['name'] for m in e2e]
    assert 'setup_s' in names and len(names) >= 2
    assert harness.metrics_for(BENCH, 'per_layer', w['name'], names)


def test_layers_named_alike():
    layers = {}
    for m in BENCH['per_layer']:
        layers.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for k, v in layers.items()
               if k in ('k1', 'k2', 'k8'))
