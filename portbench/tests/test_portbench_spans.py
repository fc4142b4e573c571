"""``common/spans.py`` and the readers of the program's spans on a Chrome
trace built by hand: host ms per call, device operations per call, device
ms per call, None where the span never opened (a program without it), and
a note on standard error where the device's records are shifted or lost,
which leaves the host readings as they are and does not fail the run."""

import pytest

from portbench import harness
from portbench.common import spans
from portbench.common.spans import host_ms, ops_per_call
from portbench.common.trace import WINDOW, Trace

SWEEP, TRAIN = 'sweep-b0r50-mixed', 'train-b0r50-mixed'
# each new reader: the span it reads and what it reads of it
READERS = {
    'sweep.prepare_ms': ('sweep.prepare', 'device'),
    'sweep.confusion_ms': ('sweep.confusion', 'device'),
    'sweep.ece_ms': ('sweep.ece', 'device'),
    'sweep.disagreement_ms': ('sweep.disagreement', 'device'),
    'sweep.host_ms': ('sweep.batch', 'host'),
    'sweep.launches': ('sweep.batch', 'ops'),
    'train.prepare_ms': ('train.prepare', 'device'),
    'train.cast_ms': ('train.cast', 'device'),
    'train.forward_ms': ('train.forward', 'device'),
    'train.loss_ms': ('train.loss', 'device'),
    'train.backward_ms': ('train.backward', 'device'),
    'train.clip_ms': ('train.clip', 'device'),
    'train.update_ms': ('train.update', 'device'),
    'train.host_ms': ('train.step', 'host'),
    'train.launches': ('train.step', 'ops'),
}
# the hand-built trace's readings of its span (µs: two calls, 30 and 20
# long, each launching three operations; one launched inside another span,
# one outside; device union 12 + 1 in the first call, 2 + 4 + 1 in the
# second)
WANT = {'host': 0.025, 'ops': 3.0, 'device': 0.010}


def _trace(name, early=0.0, lost=()):
    """The trace; ``early`` µs moves every op launched after 50 µs that
    much before its launch, ``lost`` drops those ops' records."""
    def ev(cat, n, ts, dur, corr=None):
        e = {'ph': 'X', 'cat': cat, 'name': n, 'ts': ts, 'dur': dur}
        if corr is not None:
            e['args'] = {'correlation': corr}
        return e
    launches = {1: 12, 2: 20, 3: 55, 4: 45, 5: 90, 6: 30, 7: 52, 8: 65}
    ops = [('kernel', 15, 10, 1), ('kernel', 22, 5, 2), ('kernel', 60, 4, 3),
           ('kernel', 46, 2, 4), ('kernel', 91, 3, 5),
           ('gpu_memcpy', 35, 1, 6), ('kernel', 53, 2, 7),
           ('gpu_memset', 66, 1, 8)]
    events = [ev('user_annotation', WINDOW, 0, 100),
              ev('user_annotation', name, 10, 30),
              ev('user_annotation', name, 50, 20),
              ev('user_annotation', 'other', 42, 6),
              ev('cpu_op', 'aten::add', 11, 2)]
    for cat, ts, dur, corr in ops:
        if corr in lost:
            continue
        late = launches[corr] > 50
        events.append(ev(cat, 'k', ts - early * late, dur, corr))
    events += [ev('cuda_runtime', 'cudaLaunchKernel', t, 1, c)
               for c, t in launches.items()]
    return Trace(events)


def test_host_ms_and_ops_per_call():
    ctx = {'trace': _trace('a')}
    assert host_ms(ctx, 'a') == pytest.approx(WANT['host'])
    assert ops_per_call(ctx, 'a') == pytest.approx(WANT['ops'])
    assert ops_per_call(ctx, 'other') == pytest.approx(1.0)
    assert host_ms(ctx, 'never') is None and ops_per_call(ctx, 'never') is None


@pytest.mark.parametrize('metric', sorted(READERS))
def test_reader_reads_its_span(metric):
    span, kind = READERS[metric]
    read = harness.reader(metric)
    assert read({'trace': _trace(span)}) == pytest.approx(WANT[kind])
    assert read({'trace': _trace('not.' + span)}) is None


def test_readers_are_listed_for_their_cells():
    bench = harness.manifest()
    listed = {m['name']: m for m in bench['per_layer']}
    for metric in READERS:
        m = listed[metric]
        cell = SWEEP if metric.startswith('sweep.') else TRAIN
        assert m['workloads'] == [cell] and m['source'] == 'device_trace'
        assert m['better'] == 'lower'


@pytest.mark.parametrize('metric', sorted(m for m, (_, kind) in READERS.items()
                                          if kind != 'device'))
@pytest.mark.parametrize('fault', ['early', 'lost'])
def test_host_and_launch_readers_note_an_unsound_trace(metric, fault,
                                                       monkeypatch, capsys):
    monkeypatch.setattr(spans, 'LEAD_S', 50e-6)
    span, kind = READERS[metric]
    read = harness.reader(metric)
    # sound: each op starts after its launch, or up to 50 µs before it
    for early in (0, 25):
        assert read({'trace': _trace(span, early=early)}) == \
            pytest.approx(WANT[kind])
    assert capsys.readouterr().err == ''
    if fault == 'early':        # the late ops start 53 µs before launch
        bad, why, want = _trace(span, early=53), 'not aligned', WANT[kind]
    else:                       # two of the second call's three ops lost
        bad, why = _trace(span, lost=(3, 7)), 'lost'
        want = WANT[kind] if kind == 'host' else 2.0
    # read all the same, host ms and launches by the host's clock alone
    assert read({'trace': bad}) == pytest.approx(want)
    err = capsys.readouterr().err
    assert 'unsound trace' in err and why in err
    # a program without the span reads None and notes nothing
    assert read({'trace': _trace('not.' + span, lost=(3, 7))}) is None
    assert capsys.readouterr().err == ''


def _span_device_before(trace, name):
    """``Trace.span_device`` as it read before ``span_ops``: its own walk
    over the operations."""
    import bisect
    from portbench.common.trace import length, union
    spans = sorted(trace.span_intervals(name))
    if not spans:
        return 0.0, 0
    starts = [s for s, _ in spans]
    inside = []
    for _, s, e, corr in trace.ops:
        t = trace.launch.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            inside.append((s, e))
    return length(union(inside)), len(spans)


def _launched_before(trace, name):
    """``spans.py``'s count of the operations launched inside each span as
    it read before ``span_ops``: a walk of its own."""
    import bisect
    spans = sorted(trace.span_intervals(name))
    starts = [s for s, _ in spans]
    counts = [0] * len(spans)
    for *_, corr in trace.ops:
        t = trace.launch.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            counts[i] += 1
    return counts


@pytest.mark.parametrize('variant', [{}, {'early': 25}, {'early': 53},
                                     {'lost': (3, 7)}, {'lost': (1, 2, 6)}],
                         ids=['sound', 'early25', 'early53', 'lost37',
                              'lost126'])
def test_span_ops_reads_as_the_two_walks_did(variant):
    """``Trace.span_ops`` is the one attribution of launches to spans: the
    device seconds of ``span_device`` and the counts of ``spans.py`` read
    from it equal the two walks it replaced, on the hand-built trace and
    its shifted and lossy forms, for the span, a span it overlaps and a
    span that never opened."""
    trace = _trace('a', **variant)
    for name in ('a', 'other', 'never'):
        per_span = trace.span_ops(name)
        assert trace.span_device(name) == _span_device_before(trace, name)
        assert [len(o) for o in per_span] == _launched_before(trace, name)
        assert spans._launched(trace, name) == _launched_before(trace, name)
    # the first call of 'a' (10-40 µs) launched ops 1, 2 and the copy 6;
    # op 4 (launched at 45 µs) falls in 'other', not in the closed call
    assert [sorted(op[3] for op in ops) for ops in trace.span_ops('a')][0] \
        == [c for c in (1, 2, 6) if c not in variant.get('lost', ())]
