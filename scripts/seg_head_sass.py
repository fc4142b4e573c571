#!/usr/bin/env python3
"""Counts the counter hash's integer instructions in the bf16 seg-head body.

Run from the repository root on the machine with the CUDA toolkit:
``python3 scripts/seg_head_sass.py``. It builds ``csrc/seg_head_train.cu``
(as the port does at first use), disassembles it with ``cuobjdump -sass``
and, for ``seg_mma::seg_head_mma<NT, kDrop>`` at NT = 3 (19 classes), takes
the instructions from the first to the last tensor-core instruction (HMMA):
the 16-channel slice loop, which holds each thread's 16 hidden elements of
a slice. What the dropout instantiation (K7) has beyond the one without
(K2's body) is the mask's work. Of that, it counts the integer instructions
(the hash on ``idx ^ seed``, the index increments, the compare) per hidden
element, by pipe: IMAD runs on the FMA pipe, the other integer operations
(LOP3, SHF, IADD3, ISETP, ...) on the ALU pipe, each 64 lanes per SM per
clock on an H100, and the two pipes issue side by side. The float work of
the dropout (the 1/keep product, the select) is left out. ``chip_smoke.py``
calls :func:`hash_counts` on the library it has just built and divides the
busier pipe's count by its rate at the card's boost clock: K7's hash floor.
Prints one JSON line.
"""

import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INSN = re.compile(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)')
ELEMENTS_PER_SLICE = 16   # 2 m-tiles × 2 n-tiles × 4 accumulators a thread
# integer opcodes (the part before the first '.') by the pipe that runs them
FMA_PIPE = ('IMAD',)
ALU_PIPE = ('LOP3', 'SHF', 'IADD3', 'VIADD', 'ISETP', 'SEL', 'LEA', 'PRMT',
            'IMNMX', 'VIMNMX', 'IABS', 'PLOP3')
INT_LANES_PER_SM_CLOCK = 64   # each of the two pipes, H100


def functions(sass: str) -> dict[str, list[str]]:
    """Opcodes of each function in a ``cuobjdump -sass`` listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name:
            m = INSN.search(line)
            if m:
                out[name].append(m.group(1))
    return out


def loop_body(ops: list[str]) -> list[str]:
    """The opcodes from the first HMMA to the last one."""
    idx = [i for i, op in enumerate(ops) if op.startswith('HMMA')]
    return ops[idx[0]:idx[-1] + 1]


def hash_counts(lib: Path) -> dict:
    """The dropout's instructions per hidden element in the K7 body of the
    built library ``lib``: integer ones by pipe, and every opcode the
    dropout adds."""
    cuobjdump = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([cuobjdump, '-sass', str(lib)], capture_output=True,
                          text=True, check=True).stdout
    fns = functions(sass)
    bodies = {}
    for drop in (0, 1):
        name = next(n for n in fns
                    if 'seg_head_mma' in n and f'ILi3ELb{drop}E' in n)
        bodies[drop] = loop_body(fns[name])
    extra = Counter(bodies[1]) - Counter(bodies[0])
    per_pipe = {'fma': 0, 'alu': 0}
    for op, n in extra.items():
        base = op.split('.')[0]
        if base in FMA_PIPE:
            per_pipe['fma'] += n
        elif base in ALU_PIPE:
            per_pipe['alu'] += n
    return {
        'loop_instructions': {'k2_body': len(bodies[0]),
                              'k7_body': len(bodies[1])},
        'hmma_per_loop': sum(op.startswith('HMMA') for op in bodies[1]),
        'dropout_ops_per_element': (len(bodies[1]) - len(bodies[0]))
        / ELEMENTS_PER_SLICE,
        'int_ops_per_element': {k: v / ELEMENTS_PER_SLICE
                                for k, v in per_pipe.items()},
        'extra_opcodes': dict(extra.most_common())}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from awsegbench_torch import _build

    print(json.dumps(hash_counts(_build._build('seg_head_train'))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
