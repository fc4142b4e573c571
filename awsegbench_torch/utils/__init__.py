"""Configuration management and observability."""

from .config import (
    Config,
    check_tpu_section,
    create_default_config,
    get_device_config,
    load_config,
    save_config,
    setup_logging,
    validate_config,
)
from .profiling import (
    PhaseTimers,
    ThroughputMeter,
    enable_nan_checks,
    trace,
)

__all__ = [
    "Config",
    "load_config",
    "save_config",
    "create_default_config",
    "validate_config",
    "setup_logging",
    "get_device_config",
    "check_tpu_section",
    "PhaseTimers",
    "ThroughputMeter",
    "enable_nan_checks",
    "trace",
]
