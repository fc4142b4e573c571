#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port on this machine's
cards, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result, one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``; with
``--trace 1`` also ``breakdown``; ``checks`` last: each number compared
with its limit, which the last lines of standard error repeat). With no
CUDA card, fewer cards than the cell asks for, the port's package absent,
or a module of JAX or of the JAX package loaded once the window has
closed, it exits non-zero and prints no result.
"""

import argparse
import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    os.chdir(root)
    from portbench import harness
    from portbench.common.guard import ForbiddenImport, NoCard
    started = harness.process_start()
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), started=started)
    except (NoCard, ForbiddenImport) as e:
        print(f'portbench: {e}', file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
