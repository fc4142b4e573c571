"""The harness's CPU tests: ``python3 -m pytest portbench/tests -q`` from
the root of the repository."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small sizes of the cells' traffic that a CPU run holds
TINY = dict(height=64, width=128, batch=2, pool=3, ignore_rows=2, warmup=1,
            trace_iterations=3, reference_rows=1, sample=3, sample_from=5)


def every_cell():
    """The manifest with an entry for every cell file under
    ``workloads/``, those not (or not yet) in ``BENCHMARK.json`` included,
    from the names the cell file gives."""
    import json
    from portbench import harness
    bench = harness.manifest()
    listed = {w['name'] for w in bench['workloads']}
    for path in sorted((harness.HERE / 'workloads').glob('*.json')):
        if path.stem not in listed:
            spec = json.loads(path.read_text())
            bench['workloads'].append({'name': path.stem,
                                       'config': spec['config'],
                                       'traffic': spec['traffic'],
                                       'chips': 1, 'why': spec['why']})
    return bench
