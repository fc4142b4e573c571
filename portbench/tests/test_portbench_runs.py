"""Whole runs of each cell (every cell file, those that wait under Open
questions in ``PERF.md`` too) on the CPU at a small size, the harness's
look for a card skipped: in f32 the port and the plain reference agree, the
control (the reference fed fp8 operands) comes out not correct, and every
fault planted in the timed path makes ``correct`` false."""

import pytest

from portbench import faults, harness
from portbench.tests.conftest import TINY, every_cell, single_configs

BENCH = every_cell()
CELLS = [w['name'] for w in BENCH['workloads']]


def kind(cell):
    return harness.cell(cell, BENCH)['spec']['driver']


def run(cell, seed=5, **kw):
    return harness.run(cell, seed, 0.5, False, device='cpu',
                       overrides=dict(TINY, **kw), bench=BENCH)


@pytest.mark.parametrize('cell', CELLS)
def test_reference_agrees_in_f32(cell):
    """At f32 the port's path and the reference compute the same function:
    every number far inside its limit (the sweep's and the served
    frame's exactly)."""
    out = run(cell, precision='fp32')
    assert out['correct'], out['checks']
    assert out['failed'] == 0 and out['attempted'] > 0
    for name, c in out['checks'].items():
        assert c['value'] <= c['limit'] / 20, name


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell):
    """The reference in fp8 in the program's place fails a limit."""
    c = harness.cell(cell, BENCH)
    drv = harness.driver(c['spec']['driver']).Driver(
        config=c['config'], traffic=dict(c['traffic'], **TINY), seed=9,
        device='cpu', traced=False)
    numbers = drv.control()
    limits = c['spec']['limits']
    assert any(not numbers[k] <= v for k, v in limits.items()
               if k in numbers), numbers


@pytest.mark.parametrize('cell,fault', [(c, f) for c in CELLS
                                        for f in harness.driver(kind(c))
                                        .FAULTS])
def test_fault_is_not_correct(cell, fault):
    with faults.planted(fault, harness.cell(cell, BENCH)['config']):
        out = run(cell, precision='fp32')
    assert not out['correct'], (fault, out['checks'])


@pytest.mark.parametrize('cell', CELLS)
def test_traced_run_reports_its_metrics(cell):
    out = harness.run(cell, 11, 0.5, True, device='cpu',
                      overrides=dict(TINY, precision='fp32'), bench=BENCH)
    assert out['correct']
    assert out['device']['window_s'] > 0
    assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}
    e2e = [m['name'] for m in harness.metrics_for(BENCH, 'end_to_end', cell,
                                                  ())]
    # the CPU has no device trace: the span readers find nothing to read
    for m in harness.metrics_for(BENCH, 'per_layer', cell, e2e):
        assert m['name'] not in out['metrics'] or m['unit'] != '%' or \
            0.0 <= out['metrics'][m['name']]['value'] <= 100.0


@pytest.mark.parametrize('driver', ['train', 'serve'])
def test_ensemble_drivers_refuse_another_type(driver):
    """The train and serve drivers run the ensemble alone: another type is
    refused by name before set-up."""
    config = single_configs()['segformer-b0']
    with pytest.raises(ValueError, match="ensemble only.*'segformer'"):
        harness.driver(driver).Driver(config=config, traffic={}, seed=0,
                                      device='cpu', traced=False)
