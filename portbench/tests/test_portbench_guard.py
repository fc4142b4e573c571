"""With no card a measurement fails and prints no result (no fall-back to
the CPU); the trace reader's interval arithmetic."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.common import guard
from portbench.common.trace import WINDOW, Trace, union


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                          'sweep-b0r50-mixed', '--seed', '3000000001',
                          '--seconds', '1', '--trace', '0'],
                         capture_output=True, text=True, cwd=harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'torch.cuda.is_available() is false' in out.stderr


def test_require_cards():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(guard.NoCard):
        guard.require_cards(1)
    with pytest.raises(guard.NoCard):
        harness.run('sweep-b0r50-mixed', 1, 1.0, False)


def test_union_and_trace():
    assert union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    ev = [{'ph': 'X', 'cat': 'user_annotation', 'name': WINDOW, 'ts': 0,
           'dur': 100},
          {'ph': 'X', 'cat': 'user_annotation', 'name': 'a', 'ts': 10,
           'dur': 20},
          {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'launch', 'ts': 15,
           'dur': 1, 'args': {'correlation': 1}},
          {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'launch', 'ts': 50,
           'dur': 1, 'args': {'correlation': 2}},
          {'ph': 'X', 'cat': 'kernel', 'name': 'k1', 'ts': 20, 'dur': 30,
           'args': {'correlation': 1}},
          {'ph': 'X', 'cat': 'kernel', 'name': 'k2', 'ts': 40, 'dur': 20,
           'args': {'correlation': 2}}]
    t = Trace(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)          # [20, 60)
    sec, calls = t.span_device('a')
    assert calls == 1 and sec == pytest.approx(30e-6)
    b = t.breakdown()
    assert b['device_ops'][0][0] == 'k1'
    assert b['idle_gaps'][0] == ['window', pytest.approx(40e-6)]
    json.dumps(b)
