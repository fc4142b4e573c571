"""The port's config, random streams and profiling helpers
(``utils/config.py``, ``core/prng.py``, ``utils/profiling.py``) against
the JAX package's, on the CPU.

One YAML file and its ``CONFIG_SECTION__KEY`` overrides give equal dicts
through both ``load_config``s; the defaults, the typed parsing of override
values and ``validate_config``'s errors are the same. The device layer is
the port's own: ``'auto'`` means the card and raises without one, ``'cpu'``
is the CPU, the ``tpu`` key the port does not implement raises
(a ``mesh_shape`` with a model axis), and ``remat`` builds a model whose encoder checkpoints.
"""

import logging
import os

import pytest
import torch
import yaml

from awsegbench.core import prng as jprng
from awsegbench.utils import config as jconfig
from awsegbench.utils import profiling as jprofiling
from awsegbench_torch.core.prng import RngStreams
from awsegbench_torch.eval.evaluator import Evaluator
from awsegbench_torch.models import segformer
from awsegbench_torch.models.factory import create_model, init_model_variables
from awsegbench_torch.utils import config as pconfig
from awsegbench_torch.utils import profiling as pprofiling

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OVERRIDES = [
    {},
    {'CONFIG_TRAINING__BATCH_SIZE': '8', 'CONFIG_SEED': '7',
     'CONFIG_MODEL__PRETRAINED': 'false'},
    {'CONFIG_OPTIMIZER__LEARNING_RATE': '3e-4', 'CONFIG_DEVICE': 'cpu',
     'CONFIG_TPU__PRECISION': 'fp32', 'CONFIG_NEW__DEEP__KEY': 'x'},
]


@pytest.mark.parametrize('env', OVERRIDES, ids=['plain', 'ints_bools',
                                                'floats_strings'])
def test_load_config_matches_jax(tmp_path, monkeypatch, env):
    for k in [k for k in list(os.environ)
              if k.startswith('CONFIG_')]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = pconfig.load_config('configs/default.yaml').to_dict()
    want = jconfig.load_config('configs/default.yaml').to_dict()
    assert got == want
    for k, v in env.items():
        key = k[len('CONFIG_'):].lower().replace('__', '.')
        assert pconfig.Config(got).get(key) == jconfig._parse_env_value(v)


def test_default_config_matches_jax():
    assert pconfig.create_default_config().to_dict() == \
        jconfig.create_default_config().to_dict()


@pytest.mark.parametrize('value', ['true', 'False', '3', '-2', '1.5', '1e-3',
                                   'abc', '[1, 2]', ''])
def test_parse_env_value_matches_jax(value):
    got, want = pconfig._parse_env_value(value), \
        jconfig._parse_env_value(value)
    assert got == want and type(got) is type(want)


def _broken(change):
    cfg = jconfig.create_default_config().to_dict()
    change(cfg)
    return cfg


BROKEN = {
    'missing_classes': lambda c: c['model'].pop('num_classes'),
    'missing_epochs': lambda c: c['training'].pop('epochs'),
    'zero_classes': lambda c: c['model'].update(num_classes=0),
    'negative_batch': lambda c: c['training'].update(batch_size=-1),
    'zero_epochs': lambda c: c['training'].update(epochs=0),
    'zero_lr': lambda c: c['optimizer'].update(learning_rate=0),
    'image_size_tuple': lambda c: c['data'].update(image_size=(512, 1024)),
    'image_size_three': lambda c: c['data'].update(image_size=[1, 2, 3]),
}


@pytest.mark.parametrize('name', sorted(BROKEN))
def test_validate_config_errors_match_jax(name):
    cfg = _broken(BROKEN[name])
    with pytest.raises(ValueError) as want:
        jconfig.validate_config(jconfig.Config(cfg))
    with pytest.raises(ValueError) as got:
        pconfig.validate_config(pconfig.Config(cfg))
    assert str(got.value) == str(want.value)


def test_valid_config_passes_both():
    cfg = jconfig.create_default_config().to_dict()
    jconfig.validate_config(jconfig.Config(cfg))
    pconfig.validate_config(pconfig.Config(cfg))


def test_config_object_matches_jax(tmp_path):
    ops = [('set', 'a.b.c', 1), ('set', 'a.d', [1, 2]), ('set', 'x', None),
           ('update', {'a': {'b': {'e': 2}}, 'y': 3}), ('set', 'a.b', 5)]
    j, p = jconfig.Config({'a': {'z': 0}}), pconfig.Config({'a': {'z': 0}})
    for op in ops:
        getattr(j, op[0])(*op[1:])
        getattr(p, op[0])(*op[1:])
        assert p.to_dict() == j.to_dict()
    for key in ('a.b', 'a.z', 'a.q', 'x', 'y', 'a.d'):
        assert p.get(key, 'dflt') == j.get(key, 'dflt')
        assert (key in p) == (key in j) and p[key] == j[key]
    pconfig.save_config(p, tmp_path / 'c.yaml')
    jconfig.save_config(j, tmp_path / 'j.yaml')
    assert (tmp_path / 'c.yaml').read_text() == \
        (tmp_path / 'j.yaml').read_text()
    assert pconfig.load_config(tmp_path / 'c.yaml').to_dict() == p.to_dict()


def test_load_config_errors_match_jax(tmp_path):
    with pytest.raises(FileNotFoundError):
        pconfig.load_config(tmp_path / 'absent.yaml')
    bad = tmp_path / 'bad.yaml'
    bad.write_text('a: [1, 2\n')
    for mod in (pconfig, jconfig):
        with pytest.raises((yaml.YAMLError, RuntimeError)):
            mod.load_config(bad)


def test_setup_logging_matches_jax(monkeypatch):
    """Both configure the root logger with the same arguments (recorded, so
    the test leaves the process's logging as it was)."""
    calls = []
    monkeypatch.setattr(logging, 'basicConfig',
                        lambda **kw: calls.append(kw))
    for mod in (pconfig, jconfig):
        mod.setup_logging(mod.Config({'logging': {'level': 'warning'}}))
        mod.setup_logging(mod.Config({}))
    assert calls[:2] == calls[2:]
    assert calls[0]['level'] == logging.WARNING and calls[0]['force']
    assert calls[1]['level'] == logging.INFO


def test_device_config():
    assert pconfig.get_device_config('cpu') == 'cpu'
    with pytest.raises(ValueError, match="'cuda'"):
        pconfig.get_device_config('tpu')
    if torch.cuda.is_available():
        assert pconfig.get_device_config('auto') == 'cuda'
    else:
        for name in ('auto', 'gpu', 'cuda', 'cuda:0'):
            with pytest.raises(RuntimeError, match='no CUDA device'):
                pconfig.get_device_config(name)


# A mesh_shape dict of 'data' and 'model' axes (a model axis above 1 is
# tensor parallelism) passes the config check and builds the model; the
# world's size is checked where the mesh is made, so on one process the
# Evaluator refuses a mesh of 4 ranks. A mesh_shape that is neither 'auto'
# nor a dict of axes is refused everywhere, as JAX's create_mesh refuses
# it.
TPU_RAISES = [
    ({'tpu': {'mesh_shape': {'data': 2, 'model': 2}}}, False,
     'needs 4 devices, have 1'),
    ({'tpu': {'mesh_shape': [4]}}, True, 'Unsupported mesh_shape'),
]


@pytest.mark.parametrize('cfg,refused,match', TPU_RAISES,
                         ids=['mesh_dict', 'mesh_list'])
def test_tpu_keys_the_port_lacks_raise(cfg, refused, match):
    whole = {'model': {'type': 'segformer', 'num_classes': 3,
                       **cfg.get('model', {})}, 'tpu': cfg.get('tpu', {})}
    if refused:
        with pytest.raises(ValueError, match=match):
            pconfig.check_tpu_section(cfg)
        with pytest.raises(ValueError, match=match):
            create_model(whole, device='cpu')
    else:
        pconfig.check_tpu_section(cfg)
        model = create_model(whole, device='cpu')
        assert model.SegmentationHead_0.Conv_1.out_channels == 3
    with pytest.raises(ValueError, match=match):
        Evaluator(torch.nn.Identity(), whole, device='cpu')


@pytest.mark.parametrize('cfg', [{'tpu': {'remat': True}},
                                 {'model': {'remat': True}}],
                         ids=['tpu_remat', 'model_remat'])
def test_remat_is_taken(cfg, monkeypatch):
    """``remat: true`` (in ``tpu`` or ``model``) passes the check and
    builds a model whose encoder checkpoints each block in training."""
    pconfig.check_tpu_section(cfg)
    whole = {'model': {'type': 'segformer', 'num_classes': 3,
                       'include_depth': False, **cfg.get('model', {})},
             'tpu': cfg.get('tpu', {})}
    model = create_model(whole, device='cpu').train()
    calls = []
    real = segformer.checkpoint
    monkeypatch.setattr(segformer, 'checkpoint',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model(torch.zeros(1, 32, 32, 3), torch.tensor(1, dtype=torch.int32))
    assert model.MiTEncoder_0.remat and len(calls) == 8


def test_tpu_keys_the_port_takes():
    pconfig.check_tpu_section(pconfig.create_default_config())
    pconfig.check_tpu_section({'tpu': {'mesh_shape': 'auto', 'remat': False,
                                       'precision': 'fp32'}})
    for shape in ({'data': 1}, {'data': 4}, {'data': 2, 'model': 1}):
        pconfig.check_tpu_section({'tpu': {'mesh_shape': shape}})
    model = create_model({'model': {'type': 'segformer', 'num_classes': 3},
                          'tpu': {'precision': 'fp32'}, 'seed': 3},
                         device='cpu')
    assert next(model.parameters()).dtype == torch.float32


def test_create_model_seed_from_config(caplog):
    def first(cfg, **kw):
        return next(create_model(cfg, device='cpu', **kw).parameters())
    seg = {'type': 'segformer', 'num_classes': 3}
    a = first({'model': seg, 'seed': 5})
    assert torch.equal(a, first({'model': seg}, seed=5))
    assert not torch.equal(a, first({'model': seg, 'seed': 6}))
    assert torch.equal(first(seg), first(seg, seed=0))
    # create_model reads no weights; the trainer's graft warns, with the JAX
    # package's text, when the cache directory is missing
    with caplog.at_level(logging.WARNING):
        model = create_model({'model': dict(seg, pretrained=True)},
                             device='cpu', seed=5)
        assert not caplog.text
        init_model_variables(model, {'model': dict(seg, pretrained=True)},
                             weights_dir='/nonexistent/weights')
    assert torch.equal(next(model.parameters()), a)
    assert ('Pretrained SegFormer (b0) weights not found in '
            '/nonexistent/weights — using random init') in caplog.text


def test_rng_streams():
    """Each (seed, stream, step) is its own deterministic generator."""
    rngs = RngStreams(3)
    assert RngStreams.STREAMS == jprng.RngStreams.STREAMS

    def draw(g):
        return torch.rand(8, generator=g)
    assert torch.equal(draw(rngs.fold('weather', 5)),
                       draw(RngStreams(3).fold('weather', 5)))
    seen = [draw(g) for g in (rngs.fold('weather', 5), rngs.fold('weather', 6),
                              rngs.fold('dropout', 5), rngs.key('weather'),
                              RngStreams(4).fold('weather', 5),
                              rngs.fold('weather', 1_000_000_000 + 5))]
    for i in range(len(seen)):
        for j in range(i):
            assert not torch.equal(seen[i], seen[j]), (i, j)
    with pytest.raises(ValueError):
        rngs.fold('nope', 0)


def test_throughput_meter_and_phase_timers_match_jax():
    for mod in (pprofiling, jprofiling):
        m = mod.ThroughputMeter()
        assert m.images_per_sec == 0.0
        m.update(8)
        m.update(8)
        m.stop()
        assert m.total_images == 16 and m.images_per_sec > 0
        t = mod.PhaseTimers()
        for _ in range(3):
            with t.phase('data'):
                pass
        s = t.summary()
        assert s['data']['count'] == 3 and set(s['data']) == {
            'total_s', 'count', 'mean_s'}
    m = pprofiling.ThroughputMeter()
    m.start()
    m.stop(sync_on=torch.zeros(2))          # a CPU tensor: nothing to wait
    assert m.total_images == 0


def test_trace_and_nan_checks(tmp_path):
    with pprofiling.trace(str(tmp_path / 'trace')):
        torch.ones(4).sum()
    assert any((tmp_path / 'trace').iterdir())
    with pprofiling.trace(None):
        pass
    pprofiling.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match='nan'):
            (x / x).backward()
    finally:
        pprofiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
