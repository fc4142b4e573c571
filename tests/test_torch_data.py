"""The port's dataset, loader and native host library (``data/dataset.py``,
``data/pipeline.py``'s host side, ``native/``) against the JAX package's,
on the CPU.

The same seed gives bit-equal samples: the synthetic set of each split,
tiny Cityscapes and KITTI trees written as PNGs (resized to another size,
read through ``cv2`` and, with ``cv2`` patched away on both sides, through
each package's native decoder), a corrupt image (the random fallback), and
the decoded cache. ``BatchIterator`` gives the same batches in the same
order as JAX's, with the shuffle on and off, over two epochs, with and
without ``drop_last``, on one and on four decode threads.
"""

import cv2
import numpy as np
import pytest
import torch

from awsegbench import native as jnative
from awsegbench.data import dataset as jdataset
from awsegbench.data import pipeline as jpipeline
from awsegbench_torch import native as pnative
from awsegbench_torch.data import dataset as pdataset
from awsegbench_torch.data import pipeline as ppipeline

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HW = (16, 24)
KEYS = ('image', 'label', 'weather_id', 'weather_condition', 'dataset')


def _pair(**kw):
    kw = {'data_root': 'no_data_here', 'image_size': HW, 'seed': 3, **kw}
    return (jdataset.CityscapesKITTIDataset(**kw),
            pdataset.CityscapesKITTIDataset(**kw))


def _same_items(jds, pds, passes=2):
    assert len(pds) == len(jds) > 0
    assert pds.samples == jds.samples
    for _ in range(passes):                  # the RNG runs on across passes
        for i in range(len(jds)):
            want, got = jds[i], pds[i]
            assert got.keys() == want.keys()
            for k in KEYS:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got['image'].dtype == want['image'].dtype == np.uint8
            assert got['label'].dtype == want['label'].dtype == np.int32


@pytest.mark.parametrize('split,seed', [('train', 0), ('val', 42),
                                        ('test', 7)])
def test_synthetic_samples_match_jax(split, seed):
    jds, pds = _pair(split=split, seed=seed,
                     weather_conditions=['clean', 'fog', 'night'])
    assert len(pds) == (100 if split == 'train' else 20)
    _same_items(jds, pds, passes=1)


def _png(path, array):
    path.parent.mkdir(parents=True, exist_ok=True)
    assert cv2.imwrite(str(path), array)


def _tree(root):
    """A Cityscapes tree (two cities, one image without a label, one image
    that is not a PNG) and a KITTI tree, 20×30 images."""
    rng = np.random.default_rng(5)

    def img():
        return rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)

    def lbl():
        return rng.integers(0, 34, (20, 30), dtype=np.uint8)
    cs = root / 'cityscapes'
    for city, names in (('aachen', ('a_000001', 'a_000002')),
                        ('bonn', ('b_000001',))):
        for name in names:
            _png(cs / 'leftImg8bit' / 'train' / city
                 / f'{name}_leftImg8bit.png', img())
            _png(cs / 'gtFine' / 'train' / city
                 / f'{name}_gtFine_labelIds.png', lbl())
    _png(cs / 'leftImg8bit' / 'train' / 'bonn' / 'b_000009_leftImg8bit.png',
         img())                                           # no label: skipped
    bad = cs / 'leftImg8bit' / 'train' / 'bonn' / 'b_000002_leftImg8bit.png'
    bad.write_bytes(b'not a png')                         # random fallback
    _png(cs / 'gtFine' / 'train' / 'bonn' / 'b_000002_gtFine_labelIds.png',
         lbl())
    for i in range(3):
        _png(root / 'kitti' / 'training' / 'image_2' / f'{i:06d}.png', img())
        _png(root / 'kitti' / 'training' / 'semantic' / f'{i:06d}.png',
             lbl())


@pytest.mark.parametrize('reader', ['cv2', 'native'])
@pytest.mark.parametrize('kind', ['cityscapes', 'kitti', 'combined'])
def test_real_trees_match_jax(tmp_path, monkeypatch, kind, reader):
    _tree(tmp_path)
    if reader == 'native':
        for mod in (jdataset, pdataset):
            monkeypatch.setattr(mod, '_CV2_AVAILABLE', False)
        assert pnative.available()
    jds, pds = _pair(data_root=str(tmp_path), dataset_type=kind,
                     split='train')
    assert len(pds) == {'cityscapes': 4, 'kitti': 3, 'combined': 7}[kind]
    _same_items(jds, pds)
    # the images were decoded and resized, not replaced by random ones
    first = pds.load_arrays(0)
    assert first[0] is not None and first[0].shape == HW + (3,)
    assert first[1] is not None and first[1].max() < 34


def test_native_reader_matches_cv2(tmp_path):
    """The native decoder reads what cv2 wrote, as cv2 reads it; its resize
    is the JAX package's native resize, bit for bit."""
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (13, 17), dtype=np.uint8)
    _png(tmp_path / 'rgb.png', rgb[..., ::-1])            # cv2 writes BGR
    _png(tmp_path / 'gray.png', gray)
    np.testing.assert_array_equal(pnative.imread(str(tmp_path / 'rgb.png')),
                                  rgb)
    np.testing.assert_array_equal(
        pnative.imread(str(tmp_path / 'gray.png'), grayscale=True), gray)
    assert pnative.imread(str(tmp_path / 'absent.png')) is None
    assert pnative.png_decode(b'not a png') is None
    for nearest in (False, True):
        for src in (rgb, gray):
            np.testing.assert_array_equal(
                pnative.resize_u8(src, (9, 31), nearest=nearest),
                jnative.resize_u8(src, (9, 31), nearest=nearest))


def test_native_pack_batch():
    rng = np.random.default_rng(2)
    items = [rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
             for _ in range(6)]
    np.testing.assert_array_equal(pnative.pack_batch(items, n_threads=4),
                                  np.stack(items))
    with pytest.raises(ValueError, match='differ'):
        pnative.pack_batch(items + [items[0][:4]])


def test_decoded_cache_matches_jax(tmp_path):
    _tree(tmp_path / 'data')
    kw = dict(data_root=str(tmp_path / 'data'), dataset_type='combined',
              split='train')
    jds, pds = _pair(**kw, decoded_cache=str(tmp_path / 'jcache'))
    _same_items(jds, pds)                 # fills the cache, then reads it
    assert pds._cache['present'].sum() == jds._cache['present'].sum() == 6
    for name in ('images', 'labels', 'present'):
        np.testing.assert_array_equal(pds._cache[name], jds._cache[name])
    # a second dataset on the filled cache reads the same arrays
    jds2, pds2 = _pair(**kw, decoded_cache=str(tmp_path / 'jcache'))
    _same_items(jds2, pds2, passes=1)


def _batches(it, epochs=2):
    return [list(it) for _ in range(epochs)]


def _same_batches(got, want):
    assert len(got) == len(want)
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch)
        for g, w in zip(g_epoch, w_epoch):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g['label'].dtype == np.int32
            assert g['weather_id'].dtype == g['sample_id'].dtype == np.int32


@pytest.mark.parametrize('threads', [1, 4])
@pytest.mark.parametrize('drop_last', [None, False, True])
@pytest.mark.parametrize('shuffle', [False, True])
def test_batch_iterator_matches_jax(shuffle, drop_last, threads):
    jds, pds = _pair(split='val')                          # 20 samples
    kw = dict(batch_size=6, shuffle=shuffle, seed=11, drop_last=drop_last,
              num_threads=threads)
    jit, pit = jpipeline.BatchIterator(jds, **kw), \
        ppipeline.BatchIterator(pds, **kw)
    assert len(pit) == len(jit) == (3 if pit.drop_last else 4)
    assert pit.drop_last == (shuffle if drop_last is None else drop_last)
    got, want = _batches(pit), _batches(jit)
    _same_batches(got, want)
    if shuffle:                                   # epoch 1 reshuffles
        assert not np.array_equal(got[0][0]['sample_id'],
                                  got[1][0]['sample_id'])


def test_process_slices_match_jax():
    jds, pds = _pair(split='val')
    kw = dict(batch_size=4, shuffle=True, seed=2, process_index=1,
              process_count=2)
    _same_batches(_batches(ppipeline.BatchIterator(pds, **kw), 1),
                  _batches(jpipeline.BatchIterator(jds, **kw), 1))
    for bad in (dict(batch_size=3, process_count=2),
                dict(batch_size=6, shuffle=False, process_count=2)):
        for mod, ds in ((jpipeline, jds), (ppipeline, pds)):
            with pytest.raises(ValueError):
                mod.BatchIterator(ds, **bad)


@pytest.mark.parametrize('shuffle', [False, True])
def test_create_dataloader_matches_jax(shuffle):
    jds, pds = _pair(split='test')
    kw = dict(batch_size=8, shuffle=shuffle, num_workers=2, pin_memory=True)
    p = ppipeline.create_dataloader(pds, **kw)
    j = jpipeline.create_dataloader(jds, process_count=1, **kw)
    assert (p.drop_last, p.num_threads, len(p)) == \
        (j.drop_last, j.num_threads, len(j)) == (shuffle, 2, 2 if shuffle
                                                  else 3)
    _same_batches(_batches(p, 1), _batches(j, 1))


def test_prefetch_to_device_on_cpu():
    _, pds = _pair(split='test')
    host = list(ppipeline.BatchIterator(pds, batch_size=8, shuffle=False))
    got = list(ppipeline.prefetch_to_device(host, 'cpu', lookahead=2))
    assert len(got) == len(host) == 3
    for g, h in zip(got, host):
        assert g['weather_condition'] == h['weather_condition']
        for k in ('image', 'label', 'weather_id', 'sample_id'):
            assert isinstance(g[k], torch.Tensor) and not g[k].is_pinned()
            assert g[k].dtype == torch.from_numpy(h[k]).dtype
            np.testing.assert_array_equal(g[k].numpy(), h[k])
    assert got[0]['image'].dtype == torch.uint8


class _Failing:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 2:
            raise KeyError('sample 2')
        return {'image': np.zeros((2, 2, 3), np.uint8),
                'label': np.zeros((2, 2), np.int32), 'weather_id': 0,
                'weather_condition': 'clean'}


def test_loader_errors_reach_the_consumer():
    it = iter(ppipeline.BatchIterator(_Failing(), batch_size=2,
                                      shuffle=False, num_threads=1))
    assert next(it)['image'].shape == (2, 2, 2, 3)
    with pytest.raises(KeyError, match='sample 2'):
        next(it)
