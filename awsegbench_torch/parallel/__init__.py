"""The communication layer (counterpart of ``awsegbench/parallel``):
collectives over the data mesh and halo-exact spatial tiling
(``collectives.py``), and tensor parallelism over the model axis
(``tensor.py``: ``shard_model_`` and the model group's collectives, which
JAX's GSPMD inserts by itself)."""

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
