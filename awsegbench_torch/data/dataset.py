"""Dataset layer: Cityscapes/KITTI scanners and the synthetic fallback
(counterpart of ``awsegbench/data/dataset.py``, numpy only).

The host scans, decodes and resizes; corruption and depth estimation run
on the device in ``prepare_batch``. The same seed gives the same arrays as
the JAX package's dataset, bit for bit: the RNG stream is consumed in the
same order (``finish_item`` in index order, on one thread).

* directory layouts: Cityscapes ``leftImg8bit/gtFine`` pairs, KITTI
  ``training/image_2 + semantic``;
* the synthetic fallback of 100 train / 20 val-test random samples when no
  real data is found;
* the fallback to random arrays on any image or label read failure;
* a fresh uniform weather pick per item;
* an optional decoded-array cache (uint8 memmaps).

Images are read with ``cv2`` where it is installed, else with the port's
own native PNG decoder (``awsegbench_torch/native``).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..weather.corruption import WEATHER_IDS

logger = logging.getLogger(__name__)

try:
    import cv2
    _CV2_AVAILABLE = True
except ImportError:  # pragma: no cover
    _CV2_AVAILABLE = False

from .. import native as _native


def _read_image_rgb(path: str):
    """Decode an image file to RGB uint8: cv2 if present, else the native
    C++ PNG decoder. Returns None on failure."""
    if _CV2_AVAILABLE:
        img = cv2.imread(path)
        if img is None:
            return None
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return _native.imread(path)


def _read_label_gray(path: str):
    if _CV2_AVAILABLE:
        return cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    return _native.imread(path, grayscale=True)


def _resize_rgb(img, hw):
    if _CV2_AVAILABLE:
        return cv2.resize(img, (hw[1], hw[0]))
    return _native.resize_u8(img, hw)


def _resize_label(lbl, hw):
    if _CV2_AVAILABLE:
        return cv2.resize(lbl, (hw[1], hw[0]), interpolation=cv2.INTER_NEAREST)
    return _native.resize_u8(lbl, hw, nearest=True)


# Cityscapes class mapping (34 raw ids)
CITYSCAPES_CLASSES = {
    0: 'unlabeled', 1: 'ego vehicle', 2: 'rectification border',
    3: 'out of roi', 4: 'static', 5: 'dynamic', 6: 'ground',
    7: 'road', 8: 'sidewalk', 9: 'parking', 10: 'rail track',
    11: 'building', 12: 'wall', 13: 'fence', 14: 'guard rail',
    15: 'bridge', 16: 'tunnel', 17: 'pole', 18: 'polegroup',
    19: 'traffic light', 20: 'traffic sign', 21: 'vegetation',
    22: 'terrain', 23: 'sky', 24: 'person', 25: 'rider',
    26: 'car', 27: 'truck', 28: 'bus', 29: 'caravan',
    30: 'trailer', 31: 'train', 32: 'motorcycle', 33: 'bicycle',
}


class CityscapesKITTIDataset:
    """Combined dataset with weather-id sampling and synthetic fallback.

    ``__getitem__`` returns a host-side numpy dict
    ``{image: uint8 [H,W,3], label: int32 [H,W], weather_id: int,
       weather_condition: str, dataset: str}``. Weather corruption itself
    happens on the device (``data/pipeline.py::prepare_batch``).
    """

    def __init__(
        self,
        data_root: str,
        split: str = 'train',
        image_size: Tuple[int, int] = (512, 1024),
        weather_conditions: Optional[List[str]] = None,
        apply_augmentation: bool = True,
        include_depth: bool = True,
        dataset_type: str = 'cityscapes',
        seed: Optional[int] = None,
        decoded_cache: Optional[str] = None,
        **kwargs,
    ) -> None:
        self.data_root = Path(data_root)
        self.split = split
        self.image_size = tuple(image_size)
        self.weather_conditions = weather_conditions or list(WEATHER_IDS.keys())
        self.apply_augmentation = apply_augmentation
        self.include_depth = include_depth
        self.dataset_type = dataset_type
        self._rng = np.random.default_rng(seed)

        self.samples = self._load_samples()
        logger.info(f"Loaded {len(self.samples)} samples from "
                    f"{dataset_type} dataset ({split} split)")

        # Optional decoded-array cache: steady-state epochs read raw uint8
        # memmaps instead of re-decoding PNGs. Labels are stored uint8
        # (Cityscapes/KITTI ids ≤ 255).
        self._cache = None
        if decoded_cache and any('synthetic' not in s['image']
                                 for s in self.samples):
            self._init_decoded_cache(Path(decoded_cache))

    # -- scanning -----------------------------------------------------------

    def _load_samples(self) -> List[Dict[str, str]]:
        samples: List[Dict[str, str]] = []
        if self.dataset_type in ('cityscapes', 'combined'):
            samples.extend(self._load_cityscapes_samples())
        if self.dataset_type in ('kitti', 'combined'):
            samples.extend(self._load_kitti_samples())
        if not samples:
            samples = self._generate_synthetic_samples()
        return samples

    def _load_cityscapes_samples(self) -> List[Dict[str, str]]:
        samples: List[Dict[str, str]] = []
        root = self.data_root / 'cityscapes'
        if not root.exists():
            logger.warning(f"Cityscapes data not found at {root}")
            return []
        images_dir = root / 'leftImg8bit' / self.split
        labels_dir = root / 'gtFine' / self.split
        if images_dir.exists() and labels_dir.exists():
            for city_dir in sorted(images_dir.iterdir()):
                if not city_dir.is_dir():
                    continue
                for img_file in sorted(city_dir.glob('*_leftImg8bit.png')):
                    label_file = labels_dir / city_dir.name / img_file.name.replace(
                        '_leftImg8bit.png', '_gtFine_labelIds.png')
                    if label_file.exists():
                        samples.append({
                            'image': str(img_file),
                            'label': str(label_file),
                            'dataset': 'cityscapes',
                            'city': city_dir.name,
                        })
        return samples

    def _load_kitti_samples(self) -> List[Dict[str, str]]:
        samples: List[Dict[str, str]] = []
        root = self.data_root / 'kitti'
        if not root.exists():
            logger.warning(f"KITTI data not found at {root}")
            return []
        images_dir = root / 'training' / 'image_2'
        labels_dir = root / 'training' / 'semantic'
        if images_dir.exists() and labels_dir.exists():
            for img_file in sorted(images_dir.glob('*.png')):
                label_file = labels_dir / img_file.name
                if label_file.exists():
                    samples.append({
                        'image': str(img_file),
                        'label': str(label_file),
                        'dataset': 'kitti',
                    })
        return samples

    def _generate_synthetic_samples(self) -> List[Dict[str, str]]:
        """100 train / 20 val-test synthetic placeholders."""
        num_samples = 100 if self.split == 'train' else 20
        samples = [{
            'image': f'synthetic_image_{i}.png',
            'label': f'synthetic_label_{i}.png',
            'dataset': 'synthetic',
            'synthetic': True,
        } for i in range(num_samples)]
        logger.info(f"Generated {len(samples)} synthetic samples for testing")
        return samples

    # -- decoded cache ------------------------------------------------------

    def _init_decoded_cache(self, cache_dir: Path) -> None:
        try:
            cache_dir.mkdir(parents=True, exist_ok=True)
            n = len(self.samples)
            h, w = self.image_size
            tag = f'{self.dataset_type}_{self.split}_{n}_{h}x{w}'
            img_path = cache_dir / f'{tag}_images.u8'
            lbl_path = cache_dir / f'{tag}_labels.u8'
            flag_path = cache_dir / f'{tag}_present.u8'
            fresh = not flag_path.exists()
            self._cache = {
                'images': np.memmap(img_path, dtype=np.uint8,
                                    mode='r+' if img_path.exists() else 'w+',
                                    shape=(n, h, w, 3)),
                'labels': np.memmap(lbl_path, dtype=np.uint8,
                                    mode='r+' if lbl_path.exists() else 'w+',
                                    shape=(n, h, w)),
                'present': np.memmap(flag_path, dtype=np.uint8,
                                     mode='w+' if fresh else 'r+',
                                     shape=(n,)),
            }
            if fresh:
                self._cache['present'][:] = 0
        except Exception as e:  # pragma: no cover
            logger.warning(f"decoded cache unavailable at {cache_dir}: {e}")
            self._cache = None

    # -- loading ------------------------------------------------------------

    def _decode_image(self, image_path: str) -> Optional[np.ndarray]:
        """RNG-free decode+resize; None signals the synthetic fallback."""
        if 'synthetic' in image_path:
            return None
        try:
            if os.path.exists(image_path):
                image = _read_image_rgb(image_path)
                if image is None:
                    raise ValueError(f"Could not read image from {image_path}")
            else:
                return None
        except Exception as e:
            logger.warning(f"Error loading image {image_path}: {e}, "
                           "using synthetic image")
            return None
        if image.shape[:2] != self.image_size:
            image = _resize_rgb(image, self.image_size)
        return image

    def _decode_label(self, label_path: str) -> Optional[np.ndarray]:
        if 'synthetic' in label_path:
            return None
        try:
            if os.path.exists(label_path):
                label = _read_label_gray(label_path)
                if label is None:
                    raise ValueError(f"Could not read label from {label_path}")
            else:
                return None
        except Exception as e:
            logger.warning(f"Error loading label {label_path}: {e}, "
                           "using synthetic label")
            return None
        if label.shape != self.image_size:
            label = _resize_label(label, self.image_size)
        return label.astype(np.int32)

    def _load_image(self, image_path: str) -> np.ndarray:
        image = self._decode_image(image_path)
        if image is None:
            h, w = self.image_size
            return self._rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        return image

    def _load_label(self, label_path: str) -> np.ndarray:
        label = self._decode_label(label_path)
        if label is None:
            h, w = self.image_size
            return self._rng.integers(0, 19, (h, w)).astype(np.int32)
        return label

    # -- access -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.samples)

    def load_arrays(self, idx: int):
        """RNG-free, thread-safe decode of sample ``idx``.

        Returns ``(image|None, label|None)`` — None marks a synthetic/
        failed slot whose fallback draw must happen in ``finish_item`` (on
        ONE thread, in index order) to keep the RNG stream identical to a
        sequential ``__getitem__`` loop. Serves from / fills the decoded
        cache when enabled.
        """
        info = self.samples[idx]
        cache = self._cache
        if cache is not None and cache['present'][idx]:
            return (np.array(cache['images'][idx]),
                    np.array(cache['labels'][idx]).astype(np.int32))
        image = self._decode_image(info['image'])
        label = self._decode_label(info['label'])
        if (cache is not None and image is not None and label is not None
                and label.max(initial=0) <= 255 and label.min(initial=0) >= 0):
            cache['images'][idx] = image
            cache['labels'][idx] = label.astype(np.uint8)
            cache['present'][idx] = 1
        return image, label

    def finish_item(self, idx: int, image: Optional[np.ndarray],
                    label: Optional[np.ndarray]) -> Dict[str, object]:
        """RNG-consuming tail of ``__getitem__`` (synthetic fallbacks +
        weather pick). Must be called in index order from a single thread;
        consumes the RNG exactly like the sequential path."""
        info = self.samples[idx]
        h, w = self.image_size
        if image is None:
            image = self._rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        if label is None:
            label = self._rng.integers(0, 19, (h, w)).astype(np.int32)
        # fresh uniform weather pick per access
        weather = str(self._rng.choice(self.weather_conditions))
        return {
            'image': image,
            'label': label,
            'weather_id': WEATHER_IDS[weather],
            'weather_condition': weather,
            'dataset': info['dataset'],
        }

    def __getitem__(self, idx: int) -> Dict[str, object]:
        return self.finish_item(idx, *self.load_arrays(idx))
