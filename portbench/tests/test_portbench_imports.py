"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.common.guard import FORBIDDEN, forbidden_modules
from portbench.tests.conftest import single_configs

SOURCES = sorted(p for p in harness.HERE.rglob('*.py')
                 if 'tests' not in p.relative_to(harness.HERE).parts)


def imported(path: Path) -> set[str]:
    """The top-level names of the modules ``path`` imports (absolute
    imports; relative ones stay inside the benchmark)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def relative(path: Path) -> set[str]:
    """The modules ``path``'s relative imports name, resolved against the
    package that ``path`` lies in."""
    package = ('portbench',) + path.parent.relative_to(harness.HERE).parts
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            base = package[:len(package) - node.level + 1]
            names.add('.'.join(base + ((node.module,) if node.module
                                       else ())))
    return names


@pytest.mark.parametrize('path', SOURCES,
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not imported(path) & set(FORBIDDEN)


@pytest.mark.parametrize('path', sorted((harness.HERE / 'reference')
                                        .rglob('*.py')),
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_reference_imports_nothing_of_the_port(path):
    assert imported(path) <= {'torch', 'numpy', 'math', 'functools',
                              'typing', '__future__', 're', 'logging',
                              'contextlib', 'importlib'}
    assert all(n == 'portbench.reference'
               or n.startswith('portbench.reference.')
               for n in relative(path)), relative(path)


CONFIGS = [*(json.loads(p.read_text()) for p in
             sorted((harness.HERE / 'configs').glob('*.json'))),
           *single_configs().values()]


@pytest.mark.parametrize('config', CONFIGS, ids=lambda c: c['name'])
def test_reference_builds_without_the_port(config):
    """A configuration's reference, built and run in a fresh process, loads
    no module of the port and none of the benchmark outside
    ``reference/``: the builder of its model type picks the reference's
    classes alone."""
    code = '''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from portbench.reference import model as ref_model
config = json.loads(sys.argv[2])
state = {k: torch.ones(v.shape, dtype=v.dtype)
         for k, v in ref_model.skeleton(config).state_dict().items()}
with torch.no_grad():
    ref_model.build(config, state, 'cpu')(torch.zeros(1, 64, 128, 3))
print(sorted(m for m in sys.modules
             if m.split('.')[0] in ('awsegbench_torch', 'awsegbench')
             or m.startswith('portbench.')
             and not m.startswith('portbench.reference')))
'''
    out = subprocess.run([sys.executable, '-c', code, str(harness.ROOT),
                          json.dumps(config)], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT)
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_names_compared_whole():
    assert forbidden_modules(['awsegbench_torch', 'awsegbench_torch.ops',
                              'jaxtyping', 'flaxen']) == []
    assert forbidden_modules(['awsegbench', 'awsegbench.ops', 'jax.numpy',
                              'jaxlib', 'flax.linen']) == [
        'awsegbench', 'awsegbench.ops', 'flax.linen', 'jax.numpy', 'jaxlib']


def test_a_run_loads_no_jax():
    """Everything a run imports, in a fresh process: the harness, every
    driver, reader and reference module, and the port's paths they call."""
    code = '''
import sys
sys.path.insert(0, %r)
from portbench import harness, faults, calibrate
from portbench.common import guard
for kind in ('sweep', 'train', 'serve'):
    try:
        harness.driver(kind)
    except ModuleNotFoundError:
        pass
for m in harness.manifest()['per_layer']:
    harness.reader(m['name'])
import portbench.reference.model, portbench.reference.lowp
import awsegbench_torch.eval.evaluator, awsegbench_torch.train.step
import awsegbench_torch.serving
print(guard.forbidden_modules())
''' % str(harness.ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT)
    assert out.stdout.strip().splitlines()[-1] == '[]'
