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


def single_configs() -> dict[str, dict]:
    """The factory's single-model types as configuration files: SegFormer-B0
    and DeepLabV3+ R50 alone, each with its size section of
    ``ensemble-b0-r50.json``."""
    import json
    from portbench import harness
    ens = json.loads((harness.HERE / 'configs' / 'ensemble-b0-r50.json')
                     .read_text())
    m = ens['model']
    common = {'precision': ens['precision'], 'reduced': [],
              'assumed': {'weights': ens['assumed']['weights'],
                          'classes': ens['assumed']['classes']}}
    return {
        'segformer-b0': {
            'name': 'segformer-b0',
            'source': 'https://arxiv.org/abs/2105.15203 (nvidia/mit-b0)',
            'model': {'type': 'segformer', 'num_classes': m['num_classes'],
                      'include_depth': m['include_depth'],
                      'head_mode': m['head_mode'],
                      'segformer_variant': m['segformer_variant']},
            'segformer': ens['segformer'], **common},
        'deeplabv3plus-r50': {
            'name': 'deeplabv3plus-r50',
            'source': 'https://arxiv.org/abs/1802.02611 (DeepLabV3+ R50, '
                      'OS16)',
            'model': {'type': 'deeplabv3plus',
                      'num_classes': m['num_classes'],
                      'include_depth': m['include_depth']},
            'deeplab': ens['deeplab'], **common}}
