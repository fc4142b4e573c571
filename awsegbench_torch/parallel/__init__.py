"""The data-parallel communication layer: collectives over the data mesh
and halo-exact spatial tiling (counterpart of ``awsegbench/parallel``)."""

from .collectives import (
    all_gather_batch,
    pmean_tree,
    psum_tree,
    spatial_tiles,
    stitch_tiles,
    tiled_forward,
)

__all__ = ["psum_tree", "pmean_tree", "all_gather_batch",
           "spatial_tiles", "stitch_tiles", "tiled_forward"]
