"""Weather corruption engine, depth heuristics, augmentation pipeline."""

from .augmentation import WeatherAugmentationPipeline
from .corruption import (
    WEATHER_CONDITIONS,
    WEATHER_IDS,
    apply_weather_effect,
    corrupt_batch,
    corrupt_batch_static,
    fog_density_map,
    synthetic_depth,
)
from .depth import (
    depth_to_disparity,
    estimate_depth,
    estimate_depth_batch,
    preprocess_depth_for_training,
)

__all__ = [
    "WEATHER_CONDITIONS", "WEATHER_IDS", "apply_weather_effect",
    "corrupt_batch", "corrupt_batch_static", "fog_density_map",
    "synthetic_depth", "estimate_depth", "estimate_depth_batch",
    "depth_to_disparity", "preprocess_depth_for_training",
    "WeatherAugmentationPipeline",
]
