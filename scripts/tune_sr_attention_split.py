#!/usr/bin/env python3
"""Time the port's bf16 attention kernels on one GPU at the main path's
shapes, with the backward's query split (``_SPLIT_ROWS``) swept.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit: ``python3 scripts/tune_sr_attention_split.py [split_rows ...]``
(default 512 1024 2048 4096 8192; each a multiple of 64). The shapes are
MiT-B0's four attention stages at 512×1024 and batch 8 (G = 8·heads, N the
stage's tokens, M = 512 reduced keys, D = 32), two layers per stage, bf16,
as ``chip_smoke.py`` times them. It prints the card's ``nvidia-smi`` name
and power limit, then one JSON line per split value: the backward's time
per step and per stage, both as the median of single calls between CUDA
events (``ms``, host launch time included) and as its kernels' device time
by torch.profiler (``device_ms``); then the same for the forward, and device
time by kernel over one forward and one backward per stage.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (B, H, W, device_ms, emit, nvidia_smi,  # noqa: E402
                        profile_step, time_ms)


def main(argv) -> int:
    import torch
    from awsegbench_torch.ops import attention

    if not torch.cuda.is_available():
        print('tune_sr_attention_split: no CUDA device', file=sys.stderr)
        return 1
    splits = [int(a) for a in argv] or [512, 1024, 2048, 4096, 8192]
    print(nvidia_smi(), flush=True)
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    m, d = H * W // 1024, 32
    scale = d ** -0.5
    stages = [(B * heads, (H >> (i + 2)) * (W >> (i + 2)))
              for i, heads in enumerate((1, 2, 5, 8))]
    inputs = [[torch.randn(s, generator=gen, device=dev).bfloat16()
               for s in ((g, n, d), (g, m, d), (g, m, d), (g, n, d))]
              for g, n in stages]

    def timed(call, kernels, tag):
        ms = [2 * time_ms(lambda: call(x)) for x in inputs]
        dev = [2 * device_ms(lambda: call(x), (kernels,)) for x in inputs]
        return {f'{tag}_ms': sum(ms), f'{tag}_ms_by_stage': ms,
                f'{tag}_device_ms': sum(dev),
                f'{tag}_device_ms_by_stage': dev}

    default = attention._SPLIT_ROWS
    try:
        for rows in splits:
            attention._SPLIT_ROWS = rows
            emit(dict(split_rows=rows, **timed(
                lambda x: attention.sr_attention_backward(*x, scale),
                'attn_bwd_', 'k6')))
    finally:
        attention._SPLIT_ROWS = default
    emit(dict(split_rows_in_use=attention._SPLIT_ROWS, **timed(
        lambda x: attention.sr_attention(*x[:3], scale), 'sr_attention_mma',
        'k1')))

    def both():
        for x in inputs:
            attention.sr_attention(*x[:3], scale)
            attention.sr_attention_backward(*x, scale)
    emit({'profile_one_layer_per_stage': profile_step(both)})
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
