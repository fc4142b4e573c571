"""The spans the port opens at its layer boundaries (``utils/profiling.py``
``span``), on the CPU at small sizes: how often each opens in one sweep and
one train step, that each leaf nests inside its batch's or its step's span,
that no program span takes a name the benchmark sets from outside, that no
``record_function`` is made while no profiler records, and that a recorded
run computes bit for bit what an unrecorded one does."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from awsegbench_torch.eval.evaluator import Evaluator
from awsegbench_torch.models.factory import create_model
from awsegbench_torch.train.step import TrainStep
from awsegbench_torch.utils import profiling

torch.set_num_threads(1)

NC = 4
# the spans the benchmark sets from outside, on bound methods of the port
OUTSIDE = {'portbench.window', 'sweep.accumulate', 'sweep.segformer',
           'sweep.deeplab', 'train.optim', 'train.segformer', 'train.deeplab',
           'serve.predict'}
SWEEP_LEAVES = ('sweep.prepare', 'sweep.confusion', 'sweep.ece',
                'sweep.disagreement')
TRAIN_LEAVES = ('train.prepare', 'train.cast', 'train.forward', 'train.loss',
                'train.backward', 'train.clip', 'train.update')
# one sweep over two batches, one train step on one rank
COUNTS = {
    'sweep': dict({'sweep.load': 3, 'sweep.batch': 2, 'sweep.finish': 1},
                  **{n: 2 for n in SWEEP_LEAVES}),
    'train': dict({'train.step': 1, 'train.grad_sync': 0},
                  **{n: 1 for n in TRAIN_LEAVES}),
}


class _Members(nn.Module):
    """Two per-pixel linear members and their mean, the ensemble's keys."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(9)
        self.w1 = nn.Parameter(torch.randn(3, NC, generator=g) * 2.0)
        self.w2 = nn.Parameter(torch.randn(3, NC, generator=g))

    def forward(self, x):
        m1, m2 = x @ self.w1, x @ self.w2
        return {'segmentation': (m1 + m2) / 2, 'segformer_seg': m1,
                'deeplabv3plus_seg': m2}


def _loader(n=2, b=3, h=16, w=24):
    rng = np.random.default_rng(4)
    out = []
    for _ in range(n):
        labels = rng.integers(0, NC, (b, h, w)).astype(np.int32)
        labels[:, :2, :4] = 255
        out.append({'image': rng.integers(0, 256, (b, h, w, 3),
                                          dtype=np.uint8),
                    'label': labels,
                    'weather_id': rng.integers(0, 5, b).astype(np.int32)})
    return out


def _sweep():
    ev = Evaluator(_Members(), {'model': {'num_classes': NC},
                                'tpu': {'precision': 'fp32'}},
                   device='cpu')
    return ev.run(_loader(), seed=3)


def _train():
    """One bf16 step of a SegFormer with depth heads at 32×64: its losses
    and its parameters after the step."""
    model = create_model({'type': 'segformer', 'num_classes': NC,
                          'include_depth': True}, device='cpu', seed=1)
    step = TrainStep(model, device='cpu')
    g = torch.Generator().manual_seed(2)
    images = torch.randint(0, 256, (2, 32, 64, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, NC, (2, 32, 64), generator=g)
    loss = step(images, labels, torch.tensor([1, 2]), generator=g)
    return loss, {n: p.detach().clone()
                  for n, p in step.model.named_parameters()}


RUNS = {'sweep': _sweep, 'train': _train}


def _recorded(run):
    """``run()`` under a CPU profiler: its result and the program's spans
    as (name, start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    names = {n for c in COUNTS.values() for n in c}
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name in names]
    return out, spans


@pytest.mark.parametrize('path', sorted(RUNS))
def test_spans_open_as_documented(path):
    _, spans = _recorded(RUNS[path])
    counts = {n: sum(s[0] == n for s in spans) for n in COUNTS[path]}
    assert counts == COUNTS[path]
    outer = 'sweep.batch' if path == 'sweep' else 'train.step'
    leaves = SWEEP_LEAVES if path == 'sweep' else TRAIN_LEAVES
    frames = [(s, e) for n, s, e in spans if n == outer]
    inner = sorted((s, e, n) for n, s, e in spans if n in leaves)
    for s, e, n in inner:
        assert any(fs <= s and e <= fe for fs, fe in frames), n
    for (_, e0, n0), (s1, _, n1) in zip(inner, inner[1:]):
        assert e0 <= s1, (n0, n1)          # leaves never overlap


def test_no_program_span_takes_an_outside_name():
    root = Path(__file__).resolve().parents[1] / 'awsegbench_torch'
    found = set()
    for path in root.rglob('*.py'):
        text = path.read_text()
        found |= set(re.findall(r"\bspan\('([^']+)'\)", text))
        found |= set(re.findall(r"\bspanned\(.*?'([^']+)'\)", text))
    assert {n for c in COUNTS.values() for n in c} | {'train.load'} <= found
    assert not found & OUTSIDE


@pytest.mark.parametrize('path', sorted(RUNS))
def test_no_record_function_without_a_profiler(path, monkeypatch):
    made = []
    real = profiling.record_function

    def counted(name):
        made.append(name)
        return real(name)
    monkeypatch.setattr(profiling, 'record_function', counted)
    RUNS[path]()
    assert made == []
    assert profiling.span('x') is profiling.span('y')      # the shared no-op
    _recorded(RUNS[path])
    assert sorted(set(made)) == sorted(n for n, k in COUNTS[path].items()
                                       if k)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b or (a != a and b != b)          # NaN alike


@pytest.mark.parametrize('path', sorted(RUNS))
def test_recorded_run_is_bit_identical(path):
    plain = RUNS[path]()
    recorded, _ = _recorded(RUNS[path])
    if path == 'sweep':                     # the sweep's own wall clock
        plain, recorded = ({k: v for k, v in r.items()
                            if k not in ('_throughput_images_per_sec',
                                         '_eval_seconds')}
                           for r in (plain, recorded))
    assert _equal(plain, recorded)


def test_spanned_yields_every_item_and_times_each_wait():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = list(profiling.spanned(iter([1, None, 3]), 'load'))
    assert got == [1, None, 3]
    # one span a fetch, the last finding the end
    assert sum(e.name == 'load' for e in prof.events()) == 4
    assert list(profiling.spanned([], 'load')) == []
