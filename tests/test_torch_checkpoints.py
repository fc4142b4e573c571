"""The port's checkpoints (``train/checkpoints.py``) against the JAX
package's, on the CPU.

A round trip through ``CheckpointManager`` is bit-equal: the model's
weights and BN running statistics, AdamW's state after a step and the
scheduler's state (in the meta file). After the same sequence of saves
the port's manager leaves the same names as JAX's (``latest``, ``best``,
``epoch_10``) with the same meta keys; a checkpoint restores by name and
by path, and the standalone loader reads a checkpoint directory, its
``model.pt`` and a bare state dict, all with ``weights_only=True``.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from awsegbench.train.checkpoints import CheckpointManager as JManager
from awsegbench_torch.models.factory import create_model
from awsegbench_torch.train.checkpoints import (CheckpointManager,
                                                load_checkpoint)
from awsegbench_torch.train.optim import create_optimizer, create_scheduler
from awsegbench_torch.train.step import TrainStep

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CFG = {'model': {'type': 'segformer', 'num_classes': 4,
                 'include_depth': True}, 'seed': 1}


def _stepped(seed=1):
    """A SegFormer with depth heads after one AdamW step (its BN running
    statistics and the optimiser's moments moved) and a stepped scheduler."""
    model = create_model(CFG, device='cpu', seed=seed)
    opt = create_optimizer(model.parameters(), {'type': 'adamw'})
    step = TrainStep(model, opt, precision='fp32', device='cpu')
    g = torch.Generator().manual_seed(seed)
    step(torch.randint(0, 256, (2, 32, 64, 3), generator=g,
                       dtype=torch.uint8),
         torch.randint(0, 4, (2, 32, 64), generator=g),
         torch.tensor([1, 2]), generator=g)
    sched = create_scheduler({'enabled': True, 'type': 'plateau',
                              'patience': 0}, 1e-3, 10)
    sched.step(0.5)
    sched.step(0.7)
    return model, opt, sched


def _save(manager, epoch, model, opt, sched, is_best):
    manager.save(epoch, {'epoch': epoch, 'step': epoch + 1,
                         'state_dict': model.state_dict()},
                 {'optimizer': opt.state_dict()},
                 {'val_miou': 0.25, 'val_loss': 1.5,
                  'scheduler': sched.state_dict()},
                 {'seed': 1, 'model': CFG['model']}, is_best=is_best)


@pytest.fixture(scope='module')
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp('ckpt')
    model, opt, sched = _stepped()
    manager = CheckpointManager(str(root))
    _save(manager, 4, model, opt, sched, True)
    return root, manager, model, opt, sched


def _restored(tree, opt_tree, meta):
    model = create_model(CFG, device='cpu', seed=99)
    model.load_state_dict(tree['state_dict'])
    opt = create_optimizer(model.parameters(), {'type': 'adamw'})
    opt.load_state_dict(opt_tree['optimizer'])
    sched = create_scheduler({'enabled': True, 'type': 'plateau',
                              'patience': 0}, 1e-3, 10)
    sched.load_state_dict(meta['metrics']['scheduler'])
    return model, opt, sched


def test_round_trip_is_bit_equal(saved):
    root, manager, model, opt, sched = saved
    tree, opt_tree, meta = manager.restore('latest')
    assert (tree['epoch'], tree['step']) == (4, 5)
    assert type(tree['epoch']) is int and type(tree['step']) is int
    m2, o2, s2 = _restored(tree, opt_tree, meta)
    want, got = model.state_dict(), m2.state_dict()
    assert got.keys() == want.keys()
    assert any('running_var' in k for k in want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    ws, gs = opt.state_dict(), o2.state_dict()
    assert gs['param_groups'] == ws['param_groups']
    assert len(gs['state']) == len(ws['state']) == len(list(
        model.parameters()))
    for i, st in ws['state'].items():
        assert st.keys() == gs['state'][i].keys() == {'step', 'exp_avg',
                                                      'exp_avg_sq'}
        for k, v in st.items():
            assert torch.equal(gs['state'][i][k], v), (i, k)
    assert s2.state_dict() == sched.state_dict()
    assert s2.current_lr == pytest.approx(5e-4)


@pytest.mark.parametrize('how', ['name', 'absolute', 'relative'])
def test_restore_by_name_and_path(saved, monkeypatch, how):
    root, manager, model, _, _ = saved
    if how == 'name':
        arg = 'best'
    elif how == 'absolute':
        arg = str(root / 'best')
    else:
        monkeypatch.chdir(root.parent)
        arg = f'{root.name}/best'
    tree, opt_tree, meta = manager.restore(arg)
    assert opt_tree is not None and meta['epoch'] == 4
    for k, v in model.state_dict().items():
        assert torch.equal(tree['state_dict'][k], v), k


@pytest.mark.parametrize('form', ['directory', 'model_file', 'bare'])
def test_load_checkpoint_forms(saved, tmp_path, form):
    root, _, model, _, _ = saved
    if form == 'directory':
        path, meta_epoch = root / 'latest', 4
    elif form == 'model_file':
        path, meta_epoch = root / 'latest' / 'model.pt', None
    else:
        path, meta_epoch = tmp_path / 'weights.pt', None
        torch.save(model.state_dict(), path)
    tree, meta = load_checkpoint(str(path))
    assert meta.get('epoch') == meta_epoch
    for k, v in model.state_dict().items():
        assert torch.equal(tree['state_dict'][k], v), k


def test_load_refuses_arbitrary_objects(tmp_path):
    """``weights_only=True``: a pickled object that is not tensors and
    plain containers is refused, not run."""
    path = tmp_path / 'evil.pt'
    torch.save({'state_dict': {}, 'obj': pickle.PicklingError('x')}, path)
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(str(path))


# (epoch, is_best) for 12 epochs: best at 0, 1, 4, 9; epoch_10 at 9
SEQUENCE = [(e, e in (0, 1, 4, 9)) for e in range(12)]


def test_names_and_meta_match_jax(tmp_path):
    model = create_model(CFG, device='cpu', seed=1)
    opt = create_optimizer(model.parameters(), {'type': 'adamw'})
    sched = create_scheduler({'enabled': True, 'type': 'cosine'}, 1e-3, 12)
    manager = CheckpointManager(str(tmp_path / 'port'))
    jmanager = JManager(str(tmp_path / 'jax'))
    tiny = {'epoch': np.asarray(0), 'step': np.asarray(0),
            'params': {'w': np.zeros(3, np.float32)}, 'batch_stats': {}}
    for epoch, best in SEQUENCE:
        metrics = {'val_miou': 0.1 * epoch, 'val_loss': 2.0 - 0.1 * epoch,
                   'scheduler': sched.state_dict()}
        config = {'seed': 1, 'model': CFG['model']}
        manager.save(epoch, {'epoch': epoch, 'step': epoch,
                             'state_dict': model.state_dict()},
                     {'optimizer': opt.state_dict()}, metrics, config,
                     is_best=best)
        jmanager.save(epoch, tiny, {'opt_state': {'m': np.zeros(3)}},
                      metrics, config, is_best=best)
    names = sorted(p.name for p in (tmp_path / 'port').iterdir())
    assert names == sorted(p.name for p in (tmp_path / 'jax').iterdir())
    assert names == ['best', 'best.meta.json', 'epoch_10',
                     'epoch_10.meta.json', 'latest', 'latest.meta.json']
    assert not list((tmp_path / 'port').rglob('*.tmp'))
    for name in ('best', 'epoch_10', 'latest'):
        meta = json.loads((tmp_path / 'port' / f'{name}.meta.json')
                          .read_text())
        jmeta = json.loads((tmp_path / 'jax' / f'{name}.meta.json')
                           .read_text())
        assert meta == jmeta, name
        assert sorted(p.name for p in (tmp_path / 'port' / name).iterdir()) \
            == ['model.pt', 'opt.pt']
    assert json.loads((tmp_path / 'port' / 'best.meta.json').read_text())[
        'epoch'] == 9
    assert torch.load(tmp_path / 'port' / 'epoch_10' / 'model.pt',
                      weights_only=True)['epoch'] == 9


def test_model_only_checkpoint(tmp_path):
    """A checkpoint saved without the optimiser restores with none."""
    model = create_model(CFG, device='cpu', seed=2)
    manager = CheckpointManager(str(tmp_path))
    manager.save(0, {'epoch': 0, 'step': 0,
                     'state_dict': model.state_dict()}, None,
                 {'val_miou': 0.0}, {}, is_best=True)
    _, opt_tree, meta = manager.restore('best')
    assert opt_tree is None and meta['metrics'] == {'val_miou': 0.0}
    assert not (tmp_path / 'best' / 'opt.pt').exists()
