#!/usr/bin/env python3
"""Time the port's splat kernels (K3, K4, K5) on one GPU at the paths'
shapes, for the checkout at ROOT and, where its ``csrc/splat.cu`` takes
them, over K3/K4's tile shapes.

Run on a machine with an NVIDIA H100 and the CUDA toolkit:
``python3 scripts/tune_splat_tiles.py ROOT [RxC/RxC ...]``. ROOT holds a
checkout of the repository (its ``awsegbench_torch/``); to compare two
commits, unpack the parent with ``git archive`` into a directory that
``.gitignore`` lists and run parent, change, change, parent in one call.
Each RxC/RxC (default: the source's own tiles) rebuilds ``splat.cu`` with
the batch's tile (K3) before the slash and one image's (K4) after it
(``-DSPLAT_BATCH_ROWS``, ``-DSPLAT_BATCH_COLS``, ``-DSPLAT_IMAGE_ROWS``,
``-DSPLAT_IMAGE_COLS``); C is a multiple of 16.

It prints the card's ``nvidia-smi`` name and power limit, then one JSON
line per tile shape: for each case, the median of single calls between
CUDA events (``ms``, the host's launch time included), the device time
of every device op of one call by torch.profiler (``device_ms``, a zero
fill included) and the host's time per call over 200 calls queued without
a synchronisation (``host_ms``). The cases, all made from seed 0 on the
card:

* ``k3_rain_snow``: chip_smoke.py's K3 batch, 8 images at 512×1024, rain
  and snow alternating, 500 drop slots each (rain 500 valid, snow 200);
* ``k3_eval_mix``: the eval step's weather ids 0–4 mixed over 8 images (3
  of every 5 images have no valid slot);
* ``k3_no_valid``: the rain/snow batch with every slot invalid (the cull's
  reads, no hit test);
* ``k3_no_slots``: 8 images with no slot (the mask write alone);
* ``k4``: one 512×1024 rain image (K4); ``k5``: one 2048×1024 rain image
  (K5, not retiled).

Every mask is checked bit-equal to the plain version first.
"""

import importlib.util
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _smoke():
    """This checkout's chip_smoke.py (its timers and the K3 batch), loaded
    by path so that ROOT's package is the one imported."""
    spec = importlib.util.spec_from_file_location('chip_smoke_here',
                                                  HERE / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cases(cs, dev):
    import torch
    from awsegbench_torch.ops import splat
    from awsegbench_torch.weather.corruption import draw_corruption

    g = torch.Generator(device=dev).manual_seed(0)
    h, w, b = cs.H, cs.W, cs.B
    mixed = cs.splat_mixed_batch(dev, g)
    wid = torch.arange(b, device=dev) % 5
    dr = draw_corruption(wid, h, w, g)
    rain = (wid == 2)[:, None]
    eval_mix = splat.pack_params(
        torch.where(rain, dr['rain_ax'], dr['snow_x']),
        torch.where(rain, dr['rain_ay'], dr['snow_y']),
        torch.where(rain, dr['rain_bx'], dr['snow_x']),
        torch.where(rain, dr['rain_by'], dr['snow_y']),
        torch.where(rain, dr['rain_radius'], dr['snow_radius']),
        torch.where(rain, dr['rain_valid'],
                    dr['snow_valid'] & (wid == 3)[:, None]))
    no_valid = mixed.clone()
    no_valid[..., 5] = 0.0
    single = {}
    for hw in ((h, w), (2048, 1024)):
        d = draw_corruption(torch.tensor([2], device=dev), *hw, g)
        single[hw] = splat.pack_params(
            d['rain_ax'], d['rain_ay'], d['rain_bx'], d['rain_by'],
            d['rain_radius'], d['rain_valid'])[0]
    k3 = splat.splat_coverage_batched
    return {
        'k3_rain_snow': (k3, mixed, (h, w)),
        'k3_eval_mix': (k3, eval_mix, (h, w)),
        'k3_no_valid': (k3, no_valid, (h, w)),
        'k3_no_slots': (k3, mixed[:, :0].contiguous(), (h, w)),
        'k4': (splat.splat_coverage_windowed, single[(h, w)], (h, w)),
        'k5': (splat.splat_coverage_tiled, single[(2048, 1024)],
               (2048, 1024)),
    }


def _plain(splat, params, hw):
    if params.ndim == 3:
        return splat.splat_coverage_plain(params, *hw)
    return splat.splat_coverage_plain(params[None], *hw)[0]


def _host_ms(fn, calls: int = 200) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root))
    import torch
    from awsegbench_torch import _build
    from awsegbench_torch.ops import splat

    if not torch.cuda.is_available():
        print('tune_splat_tiles: no CUDA device', file=sys.stderr)
        return 1
    if not Path(_build.__file__).is_relative_to(root):
        print(f'tune_splat_tiles: imported {_build.__file__}, not {root}',
              file=sys.stderr)
        return 1
    cs = _smoke()
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device('cuda', 0)
    cases = _cases(cs, dev)
    base_flags = list(_build.EXTRA_FLAGS['splat'])
    for tiles in argv[1:] or [None]:
        flags = []
        if tiles:
            for kind, tile in zip(('BATCH', 'IMAGE'), tiles.split('/')):
                rows, cols = tile.split('x')
                flags += [f'-DSPLAT_{kind}_ROWS={rows}',
                          f'-DSPLAT_{kind}_COLS={cols}']
        _build.EXTRA_FLAGS['splat'] = base_flags + flags
        _build._libs.pop('splat', None)
        build_s = _build.build_all(('splat',))['splat']
        out = {'root': str(root), 'tiles': tiles, 'build_seconds': build_s}
        for name, (fn, params, hw) in cases.items():
            cs.check_splat(f'{name} {tiles}', fn(params, *hw),
                           _plain(splat, params, hw), covered=False)
            out[name] = {
                'ms': cs.time_ms(lambda: fn(params, *hw), reps=50),
                'device_ms': cs.device_ms(lambda: fn(params, *hw), ('',),
                                          reps=20),
                'host_ms': _host_ms(lambda: fn(params, *hw))}
        cs.emit(out)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
