"""Data loading: the dataset with its synthetic fallback, the host loader
and the device-side batch preparation."""

from .dataset import CITYSCAPES_CLASSES, CityscapesKITTIDataset
from .pipeline import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    BatchIterator,
    create_dataloader,
    normalize_imagenet,
    prepare_batch,
)

__all__ = [
    "CityscapesKITTIDataset", "CITYSCAPES_CLASSES", "BatchIterator",
    "create_dataloader",
    "prepare_batch", "normalize_imagenet", "IMAGENET_MEAN", "IMAGENET_STD",
]
