"""Core runtime pieces: the precision policy and the random streams.

Of the JAX package's ``core`` names, these have no counterpart here:
``DATA_AXIS``, ``MODEL_AXIS``, ``create_mesh``, ``batch_sharding``,
``replicated_sharding``, ``shard_batch``, ``replicate``,
``pad_batch_to_multiple`` and ``init_distributed`` wait for the
multi-device port (ROADMAP.md §1, item 7); ``per_sample_keys`` has none,
as the port takes its draws as inputs; ``setup_compilation_cache`` is
XLA's own.
"""

from .precision import Policy, get_policy
from .prng import RngStreams

__all__ = ["Policy", "get_policy", "RngStreams"]
