"""Configuration management and observability.

The JAX package's ``PhaseTimers`` has no counterpart: the port times its
phases with ``profiling.span``, on the profiler's clock."""

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
    "ThroughputMeter",
    "enable_nan_checks",
    "trace",
]
