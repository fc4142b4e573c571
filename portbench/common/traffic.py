"""The one traffic generator: pools of uint8 batches made on the host from
the seed, and their corruption draws.

A frozen rewrite of ``chip_smoke.py:1648`` (``sweep_loader``): batch ``i``
holds ``b`` random uint8 images, random labels in [0, classes) with the
first ``ignore_rows`` rows ignored (255), and weather ids ``(i + j) % 5``
(``mixed``) or one weather for all. Unlike that loader the batches are
made on the host, pinned, so a run pays the copy to the card that a real
loader pays. The corruption's draws are the benchmark's own (the
reference's frozen ``draw_corruption``), made once per pool batch on the
device from the seed and handed to both sides."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

N_WEATHERS = 5


def weather_ids(i: int, b: int, weathers: str) -> torch.Tensor:
    """Batch i's weather ids: ``(i + j) % 5`` for 'mixed', else the id of
    the one weather named."""
    if weathers == 'mixed':
        return (torch.arange(b) + i) % N_WEATHERS
    names = ('clean', 'fog', 'rain', 'snow', 'night')
    return torch.full((b,), names.index(weathers), dtype=torch.int64)


def host_pool(seed: int, traffic: Mapping[str, Any], num_classes: int,
              pin: bool) -> list[dict[str, torch.Tensor]]:
    """``traffic['pool']`` batches of ``traffic['batch']`` at
    ``traffic['height']`` × ``traffic['width']`` on the host."""
    rng = np.random.default_rng(seed)
    n, b = traffic['pool'], traffic['batch']
    h, w = traffic['height'], traffic['width']
    pool = []
    for i in range(n):
        labels = torch.from_numpy(rng.integers(0, num_classes, (b, h, w),
                                               dtype=np.int32))
        labels[:, :traffic['ignore_rows']] = 255
        batch = {'image': torch.from_numpy(rng.integers(
                     0, 256, (b, h, w, 3), dtype=np.uint8)),
                 'label': labels,
                 'weather_id': weather_ids(i, b, traffic['weathers']),
                 'sample_id': torch.arange(i * b, (i + 1) * b)}
        if pin:
            batch = {k: v.pin_memory() for k, v in batch.items()}
        pool.append(batch)
    return pool


def corruption_draws(seed: int, pool: list[dict[str, torch.Tensor]],
                     device: str | torch.device) -> list[dict]:
    """Each pool batch's corruption draws on ``device``, from ``seed``."""
    from ..reference.weather.corruption import draw_corruption
    g = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    out = []
    for batch in pool:
        _, h, w, _ = batch['image'].shape
        out.append(draw_corruption(batch['weather_id'].to(device), h, w, g))
    return out


class Cycle:
    """``seq[i % len(seq)]`` for every i: a closed loop over a pool."""

    def __init__(self, seq) -> None:
        self.seq = seq

    def __getitem__(self, i: int):
        return self.seq[i % len(self.seq)]
