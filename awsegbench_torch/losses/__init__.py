"""Training losses."""

from .fog_density import (
    FogDensityAwareLoss,
    cross_entropy_loss,
    estimate_fog_density_from_depth,
)

__all__ = ["FogDensityAwareLoss", "cross_entropy_loss",
           "estimate_fog_density_from_depth"]
