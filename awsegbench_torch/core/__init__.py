"""Core runtime pieces: the mesh (its data axis and its model axis's
layout), the precision policy and the random streams.

Of the JAX package's ``core`` names, these have no counterpart here:
``batch_sharding`` and ``replicated_sharding`` are ``jax.sharding``'s own
(the port keeps a batch's rows with ``shard_batch`` and a replicated
value with ``replicate``); ``per_sample_keys`` has none, as the port takes
its draws as inputs; ``setup_compilation_cache`` is XLA's compile cache,
and the port's persistent cache is the kernels' build directory
(``_build.py``: each library is built once per source hash). The model
axis's layout functions keep JAX's names (``has_model_axis``,
``tp_param_shardings``, ``opt_state_shardings``, ``param_shardings``) and
return ``{parameter name: sharded dim or None}`` maps; the sharding itself
is ``parallel.tensor.shard_model_``.
"""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    DataMesh,
    TPMesh,
    create_mesh,
    has_model_axis,
    init_distributed,
    opt_state_shardings,
    pad_batch_to_multiple,
    param_shardings,
    replicate,
    shard_batch,
    tp_param_shardings,
)
from .precision import Policy, get_policy
from .prng import RngStreams

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "DataMesh", "TPMesh", "create_mesh",
    "shard_batch", "replicate", "pad_batch_to_multiple", "init_distributed",
    "has_model_axis", "tp_param_shardings", "opt_state_shardings",
    "param_shardings",
    "Policy", "get_policy", "RngStreams",
]
