"""Named random streams (counterpart of ``awsegbench/core/prng.py``).

The JAX package splits one root ``jax.random`` key into named streams and
folds a step index into a stream for each step's key. ``jax.random``
cannot be reproduced in torch, so here each stream is a seed, and
:meth:`RngStreams.fold` gives a ``torch.Generator`` on a device seeded from
(root seed, stream, step): a step's draws depend on its index only, not on
how many draws came before it, as the JAX trainer's do.
"""

from __future__ import annotations

import numpy as np
import torch


class RngStreams:
    """Named deterministic generators derived from one root seed."""

    STREAMS = ('params', 'dropout', 'weather', 'data', 'loss')

    def __init__(self, seed: int) -> None:
        self.seed = int(seed)

    def _seed(self, name: str, *step: int) -> int:
        words = (self.seed, self.STREAMS.index(name), *step)
        return int(np.random.SeedSequence(
            [w % 2 ** 64 for w in words]).generate_state(1, np.uint64)[0])

    def key(self, name: str, device: str | torch.device = 'cpu'
            ) -> torch.Generator:
        """A generator of stream ``name`` on ``device``."""
        return torch.Generator(device=device).manual_seed(self._seed(name))

    def fold(self, name: str, step: int, device: str | torch.device = 'cpu'
             ) -> torch.Generator:
        """A generator of stream ``name`` at ``step`` on ``device``."""
        return torch.Generator(device=device).manual_seed(
            self._seed(name, step))
