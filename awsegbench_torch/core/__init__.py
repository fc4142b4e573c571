"""Core runtime pieces: the data mesh, the precision policy and the random
streams.

Of the JAX package's ``core`` names, these have no counterpart here:
``batch_sharding`` and ``replicated_sharding`` are ``jax.sharding``'s own
(the port keeps a batch's rows with ``shard_batch`` and a replicated
value with ``replicate``); ``per_sample_keys`` has none, as the port takes
its draws as inputs; ``setup_compilation_cache`` is XLA's compile cache,
and the port's persistent cache is the kernels' build directory
(``_build.py``: each library is built once per source hash). A mesh with
a ``'model'`` axis above 1 is the next slice of the multi-device port
(ROADMAP.md §1).
"""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    DataMesh,
    create_mesh,
    init_distributed,
    pad_batch_to_multiple,
    replicate,
    shard_batch,
)
from .precision import Policy, get_policy
from .prng import RngStreams

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "DataMesh", "create_mesh", "shard_batch",
    "replicate", "pad_batch_to_multiple", "init_distributed",
    "Policy", "get_policy", "RngStreams",
]
