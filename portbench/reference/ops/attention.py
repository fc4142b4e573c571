"""Spatial-reduction attention of the plain reference: softmax(q·kᵀ·scale)·v
on [G, N, d] groups, in the inputs' dtype."""

from __future__ import annotations

import torch


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """q [G, N, d], k and v [G, M, d] → [G, N, d]."""
    p = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * scale, dim=-1)
    return torch.bmm(p, v)
