#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on this machine's card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --side program|control [--fault <name>] [--seconds <s>]

``program``: a run of the cell per seed (the window ``--seconds`` long),
with the fault ``--fault`` planted in the port when one is named (one of
the cell's driver's ``FAULTS``, planted by ``faults.py``); ``control``:
the reference fed fp8 operands in the program's place
(``reference/lowp.py``). One JSON line per seed with the numbers compared.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--side', choices=('program', 'control'), required=True)
    p.add_argument('--fault', default=None)
    p.add_argument('--seconds', type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench import faults, harness
    from portbench.common import guard
    bench = harness.manifest()
    c = harness.cell(args.workload, bench)
    drv = harness.driver(c['spec']['driver'])
    if args.fault is not None and args.fault not in drv.FAULTS:
        p.error(f'--fault: the {c["spec"]["driver"]} driver has the faults '
                f'{", ".join(drv.FAULTS)}')
    guard.require_cards(c['entry']['chips'])
    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.time()
        if args.side == 'control':
            numbers = drv.Driver(
                config=c['config'], traffic=c['traffic'], seed=seed,
                device='cuda', traced=False).control()
        else:
            with faults.planted(args.fault, c['config']):
                out = harness.run(args.workload, seed, args.seconds, False,
                                  bench=bench)
            numbers = {k: v['value'] for k, v in out['checks'].items()}
        import torch
        torch.cuda.empty_cache()
        print(json.dumps({'workload': args.workload, 'side': args.side,
                          'fault': args.fault, 'seed': seed,
                          'numbers': numbers,
                          'seconds': time.time() - t0}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
