"""Rain streaks and snow flakes as segments and discs (a frozen copy of
the plain coverage test of ``awsegbench_torch/ops/splat.py``): a pixel is
covered iff its centre lies within r of a valid drop's segment."""

from __future__ import annotations

import torch

_CHUNK = 50   # drops per step


def pack_params(ax, ay, bx, by, radius, valid) -> torch.Tensor:
    """Per-drop [..., N] values → [..., N, 8] rows (ax, ay, bx, by, radius,
    valid, 0, 0), float32."""
    zeros = torch.zeros_like(ax, dtype=torch.float32)
    return torch.stack([ax, ay, bx, by, radius, valid.to(torch.float32),
                        zeros, zeros], dim=-1).to(torch.float32)


def _coverage(params: torch.Tensor, px: torch.Tensor,
              py: torch.Tensor) -> torch.Tensor:
    """[N, 8] drops → bool coverage of the grid ``py`` × ``px``."""
    px, py = px[None, None, :], py[None, :, None]
    cov = torch.zeros((py.shape[1], px.shape[2]), dtype=torch.bool,
                      device=params.device)
    for s in range(0, params.shape[0], _CHUNK):
        p = params[s:s + _CHUNK, :, None, None]          # [c, 8, 1, 1]
        sax, say, sbx, sby, r, v = (p[:, j] for j in range(6))
        dx, dy = sbx - sax, sby - say
        len2 = dx * dx + dy * dy
        t = torch.where(len2 > 0, ((px - sax) * dx + (py - say) * dy)
                        / torch.clamp(len2, min=1e-8), 0.0)
        t = torch.clamp(t, 0.0, 1.0)
        ex = px - (sax + t * dx)
        ey = py - (say + t * dy)
        d2 = ex * ex + ey * ey
        cov |= ((d2 <= r * r) & (v > 0)).any(dim=0)
    return cov


def splat_coverage_batched(params: torch.Tensor, height: int,
                           width: int) -> torch.Tensor:
    """[B, N, 8] → [B, H, W] float 0/1."""
    dev = params.device
    px = torch.arange(width, dtype=torch.float32, device=dev)
    py = torch.arange(height, dtype=torch.float32, device=dev)
    return torch.stack([_coverage(p, px, py).to(torch.float32)
                        for p in params])
