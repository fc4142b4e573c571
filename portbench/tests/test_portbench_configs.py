"""Each configuration file's sizes are the ones the port builds from it, so
that the counts and the roofline readers, which read the file, count the
model that runs. Every section of the file but its metadata is a size
section, which the adapter of the configuration's model type reads off the
built model (``portbench/models/<type>.py``)."""

import json

import pytest

from portbench import harness
from portbench.common import port
from portbench.models import adapter
from portbench.reference import model as ref_model
from portbench.tests.conftest import single_configs

# the sections of a configuration file that hold no size
META = {'name', 'source', 'precision', 'reduced', 'assumed'}
CONFIGS = {p.stem: json.loads(p.read_text())
           for p in sorted((harness.HERE / 'configs').glob('*.json'))}


@pytest.mark.parametrize('config', [*CONFIGS.values(),
                                    *single_configs().values()],
                         ids=lambda c: c['name'])
def test_config_sizes_are_the_built_model(config):
    sizes = adapter(config).sizes(port.skeleton(config))
    assert set(sizes) == set(config) - META
    for section, got in sizes.items():
        want = config[section]
        if section == 'model':          # the model section's sizes alone
            want = {k: want[k] for k in got}
        assert want == got, section


def test_a_type_without_an_adapter_names_its_file():
    config = dict(CONFIGS['ensemble-b0-r50'], model={'type': 'mask2former'})
    with pytest.raises(ModuleNotFoundError, match='portbench/models/'
                                                  'mask2former.py'):
        adapter(config)


def test_a_type_without_a_reference_builder_names_its_file():
    config = dict(CONFIGS['ensemble-b0-r50'], model={'type': 'mask2former'})
    with pytest.raises(ModuleNotFoundError, match='portbench/reference/'
                                                  'builders/mask2former.py'):
        ref_model.skeleton(config)
