#!/usr/bin/env python3
"""Run the port's eval and train paths, as ``chip_smoke.py`` drives them,
for the checkout at a given root: the way to compare two commits on one
card.

Run on a machine with an NVIDIA H100 and the CUDA toolkit:
``python3 scripts/run_paths.py ROOT`` where ROOT holds a checkout of the
repository (its ``chip_smoke.py`` and ``awsegbench_torch/``). It builds that
checkout's kernels and prints ``chip_smoke.py``'s ``main_path``, ``layers``,
``train_path`` and ``train_layers`` lines (images/s, step time, peak memory,
launches, each layer alone, device time by kernel). To compare a parent
with a change, unpack the parent (``git archive``) into a directory that
``.gitignore`` lists and run parent, change, change, parent in one call.
"""

import sys
from pathlib import Path


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke
    from awsegbench_torch import _build

    if not torch.cuda.is_available():
        print('run_paths: no CUDA device', file=sys.stderr)
        return 1
    if not Path(_build.__file__).is_relative_to(root):
        print(f'run_paths: imported {_build.__file__}, not {root}',
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.nvidia_smi(), flush=True)
    chip_smoke.emit({'root': str(root), 'build_seconds': _build.build_all()})
    dev = torch.device('cuda', 0)
    chip_smoke.phase_main_path(dev)
    chip_smoke.phase_train_path(dev)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
