"""The card guard and the check that nothing of JAX was loaded."""

from __future__ import annotations

import subprocess
import sys

# top-level module names that no run may hold once its window has closed:
# JAX, and the JAX package the port was made from (whose name begins the
# port's own, so names are compared whole)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'awsegbench')


class ForbiddenImport(RuntimeError):
    """A module of JAX or of the JAX package was loaded."""

    def __init__(self, names) -> None:
        super().__init__('modules of JAX or of the JAX package were '
                         f'loaded: {", ".join(names)}')
        self.names = names


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


def require_cards(n: int) -> None:
    """Raises ``NoCard`` unless torch sees at least ``n`` CUDA cards (no
    fall-back to the CPU)."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard('torch.cuda.is_available() is false: this benchmark '
                     'measures the port on an NVIDIA card')
    if torch.cuda.device_count() < n:
        raise NoCard(f'{torch.cuda.device_count()} CUDA cards, the cell '
                     f'asks for {n}')


def forbidden_modules(modules=None) -> list[str]:
    """The names in ``sys.modules`` (or ``modules``) whose top-level name,
    the part before the first dot, is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split('.', 1)[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    'unknown' where it cannot."""
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'unknown'
