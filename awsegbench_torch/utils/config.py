"""Configuration management (counterpart of ``awsegbench/utils/config.py``).

The same ``Config`` (dot keys, deep merge), YAML load and save,
``CONFIG_SECTION__KEY=value`` environment overrides with typed parsing,
defaults, validation and logging setup as the JAX package, so one YAML
file serves both packages. What differs is the device layer:
:func:`get_device_config` returns a torch device string, and ``'auto'``
means ``'cuda'``, raising when no card is present (there is no silent CPU
fallback; ``device: cpu`` or ``--device cpu`` asks for the CPU).

The ``tpu`` section keeps its keys. ``precision`` picks the port's
precision policy (``core/precision.py``), ``mesh_shape`` the data mesh
(``core/mesh.py``); :func:`check_tpu_section` refuses a ``'model'`` axis
above 1, which the port does not implement yet. ``donate_state`` has nothing to do in
the port, whose optimiser updates the parameters in place, and
``dropout_rng`` picks between two JAX streams, neither of which torch can
reproduce: the port's dropout is its own counter hash and generator draws.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

import yaml

from .._device import resolve_device

logger = logging.getLogger(__name__)


class Config:
    """Dot-notation configuration wrapper: ``get``/``set`` with
    dot-separated keys, ``update`` with deep merge, bracket access, ``in``
    checks."""

    def __init__(self, config_dict: Optional[Dict[str, Any]] = None) -> None:
        self._config: Dict[str, Any] = config_dict or {}

    def get(self, key: str, default: Any = None) -> Any:
        value: Any = self._config
        for k in key.split('.'):
            if isinstance(value, dict) and k in value:
                value = value[k]
            else:
                return default
        return value

    def set(self, key: str, value: Any) -> None:
        _set_nested_value(self._config, key, value)

    def update(self, other_config: Union['Config', Dict[str, Any]]) -> None:
        other = (other_config._config if isinstance(other_config, Config)
                 else other_config)
        self._config = _deep_merge(self._config, other)

    def to_dict(self) -> Dict[str, Any]:
        return self._config.copy()

    def __getitem__(self, key: str) -> Any:
        return self.get(key)

    def __setitem__(self, key: str, value: Any) -> None:
        self.set(key, value)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __repr__(self) -> str:
        return f"Config({self._config})"


def _deep_merge(dict1: Dict[str, Any], dict2: Dict[str, Any]) -> Dict[str, Any]:
    result = dict1.copy()
    for key, value in dict2.items():
        if key in result and isinstance(result[key], dict) and isinstance(value, dict):
            result[key] = _deep_merge(result[key], value)
        else:
            result[key] = value
    return result


def load_config(config_path: Union[str, Path]) -> Config:
    """Load a YAML config and apply the ``CONFIG_*`` environment
    overrides."""
    config_path = Path(config_path)
    if not config_path.exists():
        raise FileNotFoundError(f"Configuration file not found: {config_path}")
    try:
        with open(config_path, 'r', encoding='utf-8') as f:
            config_dict = yaml.safe_load(f) or {}
        config_dict = _apply_env_overrides(config_dict)
        logger.info(f"Loaded configuration from {config_path}")
        return Config(config_dict)
    except yaml.YAMLError as e:
        raise yaml.YAMLError(f"Error parsing configuration file {config_path}: {e}")
    except Exception as e:
        raise RuntimeError(f"Error loading configuration from {config_path}: {e}")


def save_config(config: Config, config_path: Union[str, Path]) -> None:
    """Save a configuration to a YAML file."""
    config_path = Path(config_path)
    config_path.parent.mkdir(parents=True, exist_ok=True)
    try:
        with open(config_path, 'w', encoding='utf-8') as f:
            yaml.safe_dump(config.to_dict(), f, default_flow_style=False, indent=2)
        logger.info(f"Saved configuration to {config_path}")
    except Exception as e:
        raise RuntimeError(f"Error saving configuration to {config_path}: {e}")


def _apply_env_overrides(config_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Apply ``CONFIG_SECTION__SUBSECTION__KEY=value`` overrides."""
    env_prefix = "CONFIG_"
    for env_key, env_value in os.environ.items():
        if not env_key.startswith(env_prefix):
            continue
        config_key = env_key[len(env_prefix):].lower().replace('__', '.')
        parsed_value = _parse_env_value(env_value)
        _set_nested_value(config_dict, config_key, parsed_value)
        logger.debug(f"Applied environment override: {config_key} = {parsed_value}")
    return config_dict


def _parse_env_value(value: str) -> Union[str, int, float, bool]:
    """bool → int → float → str, in that order."""
    if value.lower() in ('true', 'false'):
        return value.lower() == 'true'
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def _set_nested_value(config_dict: Dict[str, Any], key: str, value: Any) -> None:
    keys = key.split('.')
    current = config_dict
    for k in keys[:-1]:
        if k not in current or not isinstance(current[k], dict):
            current[k] = {}
        current = current[k]
    current[keys[-1]] = value


def create_default_config() -> Config:
    """The default config tree, key for key the JAX package's (and
    ``configs/default.yaml``'s schema)."""
    default_config = {
        'model': {
            'type': 'ensemble',
            'num_classes': 19,
            'include_depth': True,
            'pretrained': True,
            'ensemble_strategy': 'weighted_average',
            'temperature_scaling': True,
            'segformer_variant': 'b0',
        },
        'data': {
            'dataset_type': 'combined',
            'data_root': 'data',
            'image_size': [512, 1024],
            'weather_conditions': ['clean', 'fog', 'rain', 'snow', 'night'],
            'apply_augmentation': True,
            'include_depth': True,
        },
        'training': {
            'batch_size': 2,
            'epochs': 100,
            'num_workers': 4,
            'pin_memory': True,
            'grad_clip': 1.0,
        },
        'optimizer': {
            'type': 'adamw',
            'learning_rate': 0.001,
            'weight_decay': 0.01,
            'betas': [0.9, 0.999],
        },
        'scheduler': {
            'enabled': True,
            'type': 'cosine',
            'eta_min': 0.000001,
        },
        'loss': {
            'type': 'fog_density_aware',
            'base_loss': 'cross_entropy',
            'depth_weight': 0.5,
            'fog_sensitivity': 2.0,
            'depth_loss_weight': 0.1,
        },
        'early_stopping': {
            'patience': 10,
            'min_delta': 0.001,
            'restore_best_weights': True,
        },
        'mlflow': {
            'enabled': True,
            'experiment_name': 'adverse_weather_segmentation',
            'run_name': None,
        },
        'evaluation': {
            'num_bins': 15,
            'auroc_mode': 'histogram',
            'spatial_tiling': 'auto',
            'tile_size': 'auto',
            'tile_halo': 128,
            'weather_conditions': ['clean', 'fog', 'rain', 'snow', 'night'],
        },
        'logging': {
            'level': 'INFO',
            'format': '%(asctime)s - %(name)s - %(levelname)s - %(message)s',
        },
        'paths': {
            'checkpoints': 'checkpoints',
            'logs': 'logs',
            'results': 'results',
        },
        'device': 'auto',
        'seed': 42,
        'tpu': {
            'mesh_shape': 'auto',
            'precision': 'bf16',
            'donate_state': True,
            'dropout_rng': 'rbg',
        },
    }
    return Config(default_config)


def get_device_config(device_setting: str = 'auto') -> str:
    """The torch device string for the config's ``device``: ``'auto'``
    and ``'gpu'`` mean ``'cuda'``; ``'cpu'`` and ``'cuda[:N]'`` stay as
    given. Raises when a CUDA device is asked for and no card is present,
    and on a device the port has no path for (``'tpu'``)."""
    name = {'auto': 'cuda', 'gpu': 'cuda'}.get(device_setting,
                                                device_setting)
    if name != 'cpu' and not name.startswith('cuda'):
        raise ValueError(f"device {device_setting!r}: the port runs on "
                         "'cuda' (or 'auto') or 'cpu'")
    return str(resolve_device(name))


def check_tpu_section(config: Any) -> None:
    """Checks the ``tpu`` section's ``mesh_shape``: ``'auto'`` (one data
    axis over the world) or a dict of ``'data'`` and ``'model'`` sizes,
    such as ``{'data': n}``. Raises ``NotImplementedError`` for a
    ``'model'`` axis above 1 (tensor parallelism, the next slice of the
    multi-device port) and ``ValueError`` for any other form; the world's
    size is checked where the mesh is made (``core.mesh.create_mesh``).
    ``remat`` (in ``tpu`` or ``model``) is taken:
    ``models.factory.create_model`` reads it."""
    from ..core.mesh import MODEL_AXIS, MODEL_AXIS_MESSAGE
    shape = (config.get('tpu') or {}).get('mesh_shape', 'auto')
    if shape in (None, 'auto'):
        return
    if not isinstance(shape, dict) or not set(shape) <= {'data', 'model'}:
        raise ValueError(f'Unsupported mesh_shape: {shape!r}')
    if int(shape.get(MODEL_AXIS, 1)) > 1:
        raise NotImplementedError(f'tpu.mesh_shape={shape!r}: '
                                  f'{MODEL_AXIS_MESSAGE}')


def setup_logging(config: Config) -> None:
    """Configure the root logger from the config's ``logging`` section."""
    log_config = config.get('logging', {}) or {}
    log_level = log_config.get('level', 'INFO')
    log_format = log_config.get('format', '%(asctime)s - %(name)s - %(levelname)s - %(message)s')
    numeric_level = getattr(logging, str(log_level).upper(), logging.INFO)
    logging.basicConfig(level=numeric_level, format=log_format, force=True)
    logger.info("Logging configured")


def validate_config(config: Config) -> None:
    """Validate the required fields and their ranges."""
    required_fields = [
        'model.num_classes',
        'data.image_size',
        'training.batch_size',
        'training.epochs',
        'optimizer.learning_rate',
    ]
    for field in required_fields:
        if config.get(field) is None:
            raise ValueError(f"Required configuration field missing: {field}")

    if config.get('model.num_classes', 0) <= 0:
        raise ValueError("model.num_classes must be positive")
    if config.get('training.batch_size', 0) <= 0:
        raise ValueError("training.batch_size must be positive")
    if config.get('training.epochs', 0) <= 0:
        raise ValueError("training.epochs must be positive")
    if config.get('optimizer.learning_rate', 0) <= 0:
        raise ValueError("optimizer.learning_rate must be positive")

    image_size = config.get('data.image_size')
    if not isinstance(image_size, list) or len(image_size) != 2:
        raise ValueError("data.image_size must be a list of two integers [height, width]")

    logger.info("Configuration validation passed")
