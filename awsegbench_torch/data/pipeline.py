"""The host-side loader and the device-side batch preparation
(counterpart of ``awsegbench/data/pipeline.py``).

Host side: :class:`BatchIterator` stacks a map-style dataset's items into
numpy batches on a producer thread (decode on a thread pool, the RNG tail
in index order, so the batches equal the JAX package's bit for bit), and
:func:`prefetch_to_device` copies each batch to the card from pinned
memory one batch ahead. ``drop_last`` defaults to ``shuffle``.

Device side: as the corruption, the train-time augmentation is split into
its draws (:func:`draw_augment`, from an explicit ``torch.Generator``) and
a deterministic apply (:func:`apply_augment`), so tests can hand the JAX
path's draws to the port.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import const
from ..weather.corruption import apply_corruption, draw_corruption
from ..weather.depth import estimate_depth_batch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _stack(items, num_threads: int) -> np.ndarray:
    """Batch-stack with the native threaded packer when it is available
    (its memcpy releases the interpreter lock), else ``np.stack``."""
    if num_threads > 1 and len(items) > 1:
        from .. import native as _native
        if _native.available():
            return _native.pack_batch(items, n_threads=min(num_threads,
                                                           len(items)))
    return np.stack(items)


class BatchIterator:
    """Shuffled batch iterator over a map-style dataset, with a producer
    thread that keeps ``prefetch`` batches ready.

    Yields dicts of stacked numpy arrays: ``{image: uint8 [B, H, W, 3],
    label: int32 [B, H, W], weather_id: int32 [B], sample_id: int32 [B]}``
    plus the per-sample weather names. The shuffle of epoch ``e`` is seeded
    with ``seed + e``. ``process_index``/``process_count`` slice each global
    batch for one of several loading processes, as the JAX package does:
    every process builds the same shuffle and keeps its contiguous rows
    (``batch_size`` stays the global batch's size).
    """

    def __init__(self, dataset, batch_size: int = 8, shuffle: bool = True,
                 seed: int = 0, drop_last: Optional[bool] = None,
                 prefetch: int = 2, num_threads: int = 4,
                 process_index: int = 0, process_count: int = 1) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = shuffle if drop_last is None else drop_last
        self.prefetch = prefetch
        self.num_threads = max(1, num_threads)
        self.process_index = process_index
        self.process_count = max(1, process_count)
        if self.process_count > 1:
            if batch_size % self.process_count:
                raise ValueError(
                    f'global batch_size {batch_size} must divide over '
                    f'{self.process_count} processes')
            if not self.drop_last and len(dataset) % batch_size:
                raise ValueError(
                    'process-sharded loading requires drop_last=True or a '
                    'dataset length divisible by the global batch size '
                    '(uneven final batches cannot shard across hosts)')
        self._epoch = 0
        self._pool = None  # lazy decode ThreadPoolExecutor

    def _decode_pool(self):
        if self._pool is None and self.num_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_threads,
                thread_name_prefix='awseg-decode')
        return self._pool

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> list[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        batches = []
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                continue
            if self.process_count > 1:
                local = len(idx) // self.process_count
                idx = idx[self.process_index * local:
                          (self.process_index + 1) * local]
            batches.append(idx)
        return batches

    def _collate(self, idx: np.ndarray) -> Dict[str, Any]:
        ds = self.dataset
        pool = self._decode_pool()
        if (pool is not None and hasattr(ds, 'load_arrays')
                and hasattr(ds, 'finish_item')):
            # Decode in parallel (RNG-free; cv2 and the native decoder
            # release the interpreter lock), then the RNG tail in index
            # order on this thread: the same stream as one thread.
            decoded = list(pool.map(ds.load_arrays, (int(i) for i in idx)))
            items = [ds.finish_item(int(i), im, lb)
                     for i, (im, lb) in zip(idx, decoded)]
        else:
            items = [ds[int(i)] for i in idx]
        return {
            'image': _stack([it['image'] for it in items], self.num_threads),
            'label': _stack([np.asarray(it['label'], np.int32)
                             for it in items], self.num_threads),
            'weather_id': np.asarray([it['weather_id'] for it in items],
                                     np.int32),
            'weather_condition': [it['weather_condition'] for it in items],
            'sample_id': idx.astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batch_indices()
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            try:
                for idx in batches:
                    q.put(self._collate(idx))
                q.put(stop)
            except BaseException as e:  # handed to the consumer, re-raised
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def _to_device(batch: Dict[str, Any], device: str | torch.device
               ) -> Dict[str, Any]:
    """A host batch's arrays as tensors on ``device``: on a card, copied
    from pinned host memory without waiting for the copy; on the CPU, the
    arrays themselves. Entries that are not arrays pass through."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            if device.type == 'cuda':
                t = t.pin_memory().to(device, non_blocking=True)
            v = t
        out[k] = v
    return out


def prefetch_to_device(batch_iter: Iterable[Dict[str, Any]],
                       device: str | torch.device, lookahead: int = 1
                       ) -> Iterator[Dict[str, Any]]:
    """Yield each batch on ``device`` while the copies of the next
    ``lookahead`` batches are already queued (:func:`_to_device`); the uint8
    images go to the card as uint8."""
    pending = []
    for batch in batch_iter:
        pending.append(_to_device(batch, device))
        if len(pending) > lookahead:
            yield pending.pop(0)
    yield from pending


def create_dataloader(dataset, batch_size: int = 8, shuffle: bool = True,
                      num_workers: int = 4, pin_memory: bool = True,
                      **kwargs) -> BatchIterator:
    """Loader factory of the reference's signature: ``num_workers`` decode
    threads, ``drop_last`` defaulting to ``shuffle``. ``pin_memory`` is
    accepted and has no effect here: :func:`prefetch_to_device` pins what
    goes to a card. With a process group of more than one rank up, each
    process loads its rows of every global batch (``process_index`` and
    ``process_count`` from the group's rank and size) unless
    ``process_count`` is given, as the JAX factory reads
    ``jax.process_*``."""
    if 'process_count' not in kwargs and dist.is_available() \
            and dist.is_initialized() and dist.get_world_size() > 1:
        kwargs['process_index'] = dist.get_rank()
        kwargs['process_count'] = dist.get_world_size()
    return BatchIterator(dataset, batch_size=batch_size, shuffle=shuffle,
                         num_threads=num_workers,
                         drop_last=kwargs.pop('drop_last', None),
                         **kwargs)


def normalize_imagenet(images_u8: torch.Tensor) -> torch.Tensor:
    """(x/255 − mean)/std, NHWC float32."""
    mean = const(tuple, IMAGENET_MEAN, device=images_u8.device)
    std = const(tuple, IMAGENET_STD, device=images_u8.device)
    return (images_u8.to(torch.float32) / 255.0 - mean) / std


def draw_augment(batch: int, generator: torch.Generator,
                 device: torch.device) -> dict[str, torch.Tensor]:
    """The draws of ``_train_augment`` for ``batch`` images: horizontal flip
    with p 0.5; brightness/contrast with p 0.3, contrast factor
    ``alpha = 1 + U(−0.2, 0.2)`` and brightness ``beta = U(−0.2, 0.2)``."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((batch,), generator=generator,
                                           device=device)
    return {'do_flip': u(0.0, 1.0) < 0.5, 'do_bc': u(0.0, 1.0) < 0.3,
            'alpha': 1.0 + u(-0.2, 0.2), 'beta': u(-0.2, 0.2)}


def apply_augment(images_u8: torch.Tensor, labels: torch.Tensor,
                  draws: dict[str, torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """HorizontalFlip + RandomBrightnessContrast with the given draws, per
    image: ``clip(round(x·alpha + beta·255), 0, 255)`` (round half to even,
    as JAX)."""
    flip = draws['do_flip']
    images_u8 = torch.where(flip[:, None, None, None], images_u8.flip(2),
                            images_u8)
    labels = torch.where(flip[:, None, None], labels.flip(2), labels)
    adjusted = (images_u8.float() * draws['alpha'][:, None, None, None]
                + (draws['beta'] * 255.0)[:, None, None, None])
    adjusted = torch.clamp(torch.round(adjusted), 0, 255).to(torch.uint8)
    images_u8 = torch.where(draws['do_bc'][:, None, None, None], adjusted,
                            images_u8)
    return images_u8, labels


def prepare_batch(images_u8: torch.Tensor, labels: torch.Tensor,
                  weather_ids: torch.Tensor,
                  generator: torch.Generator | None = None,
                  draws: dict[str, torch.Tensor] | None = None,
                  include_depth: bool = True, train: bool = False,
                  apply_augmentation: bool = True,
                  aug_draws: dict[str, torch.Tensor] | None = None
                  ) -> dict[str, torch.Tensor]:
    """Corrupt → (estimate depth) → (augment, in train mode) → normalize,
    on the images' device.

    The corruption draws come from ``generator`` (a ``torch.Generator`` on
    the images' device), or are given as ``draws`` (as from
    :func:`~awsegbench_torch.weather.corruption.draw_corruption`); the
    augmentation's likewise, or as ``aug_draws`` (:func:`draw_augment`).
    Depth is estimated before the flip, as in the JAX package.
    Returns {image: float32 NHWC normalized, label, weather_id, depth?}.
    """
    augment = train and apply_augmentation
    if (draws is None or (augment and aug_draws is None)) and generator is None:
        raise ValueError('prepare_batch needs a generator or draws')
    if draws is None:
        draws = draw_corruption(weather_ids, images_u8.shape[1],
                                images_u8.shape[2], generator)
    corrupted = apply_corruption(images_u8, weather_ids, draws)
    depth = estimate_depth_batch(corrupted) if include_depth else None
    if augment:
        if aug_draws is None:
            aug_draws = draw_augment(images_u8.shape[0], generator,
                                     images_u8.device)
        corrupted, labels = apply_augment(corrupted, labels, aug_draws)
    out = {'image': normalize_imagenet(corrupted), 'label': labels,
           'weather_id': weather_ids}
    if depth is not None:
        out['depth'] = depth
    return out
