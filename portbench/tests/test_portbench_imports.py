"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.common.guard import FORBIDDEN, forbidden_modules

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


@pytest.mark.parametrize('path', SOURCES,
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not imported(path) & set(FORBIDDEN)


@pytest.mark.parametrize('path', sorted((harness.HERE / 'reference')
                                        .rglob('*.py')),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert imported(path) <= {'torch', 'numpy', 'math', 'functools',
                              'typing', '__future__', 're', 'logging',
                              'contextlib'}


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
