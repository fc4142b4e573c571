"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``csrc/build/``
the first time a launch needs it, then loaded with ``ctypes``. The library
file name carries a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header is rebuilt and a stale library
is never loaded. A failed build raises with nvcc's output.

Every kernel is launched by :func:`launch`, the CUDA kernel of an
``awseg::`` op (``ops/library.py``), which counts it in the launch table
(``launches``, ``design_launches``).

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = CSRC / 'build'

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# Per-source extra flags. The splat mask must equal its plain version bit
# for bit, so no multiply-add contraction may move a ``d2 <= r*r`` decision.
EXTRA_FLAGS = {'splat': ['-fmad=false']}
KERNELS = ('sr_attention', 'sr_attention_bwd', 'seg_head', 'seg_head_train',
           'depth_stage1_train', 'pp_adjoint', 'splat', 'ms_deform_attn',
           'bn_act', 'bn_train', 'window_attention')

# The launch table: the kernels launched since it was last cleared, by op
# name and, for the ops with two designs, by (op name, design).
launches: Counter[str] = Counter()
design_launches: Counter[tuple[str, str]] = Counter()

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# name -> (seconds the build took, nvcc's output: ptxas register/smem report)
build_log: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels are built on the '
                       'machine with the card')


def _lib_path(name: str) -> tuple[Path, list[str]]:
    src = CSRC / f'{name}.cu'
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
    headers = b''.join(h.read_bytes() for h in sorted(CSRC.glob('*.cuh')))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + ' '.join(flags).encode())
    return BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so', flags


def _build(name: str) -> Path:
    """The library for ``name``, compiled unless already built."""
    out, flags = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    t0 = time.time()
    proc = subprocess.run([_nvcc(), *flags, '-o', str(tmp),
                           str(CSRC / f'{name}.cu')],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for csrc/{name}.cu (exit '
                           f'{proc.returncode}):\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)
    build_log[name] = (time.time() - t0, proc.stdout + proc.stderr)
    return out


def build_all(names=KERNELS) -> dict[str, float]:
    """Build every kernel library at once (one nvcc per source, all started
    together) and load them; returns each build's seconds (0 when cached)."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        with ThreadPoolExecutor(max(len(todo), 1)) as pool:
            for n, path in zip(todo, pool.map(_build, todo)):
                _libs[n] = ctypes.CDLL(str(path))
    return {n: build_log.get(n, (0.0, ''))[0] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def operand(t):
    """``t`` contiguous and 16-byte aligned, as the tensor-core kernels copy
    rows with 16-byte ``cp.async``."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(op: str, name: str, symbol: str, argtypes: list, *args,
           design: str | None = None) -> None:
    """Launch the C entry point ``symbol`` of ``csrc/<name>.cu`` for the op
    ``op`` on PyTorch's current stream, raise if it returned a CUDA error,
    and count it in the launch table (under ``design`` too, when given).

    ``argtypes`` are the C types of ``args`` (declared on the first call):
    ``ctypes.c_void_p`` for a tensor (passed as its data pointer) or None
    (a null pointer), ``ctypes.c_int`` and the like for numbers; the first
    is a tensor. The stream goes last: the raw handle of its device, as
    PyTorch's own Triton launcher reads it (``torch.cuda.current_stream``
    builds a Stream object first, a large share of a small kernel's host
    time)."""
    import torch
    lib = load(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
    tensor = torch.Tensor
    rc = fn(*[a.data_ptr() if isinstance(a, tensor) else a for a in args],
            torch._C._cuda_getCurrentRawStream(args[0].device.index))
    if rc != 0:
        err = lib.awseg_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f'{op}: CUDA launch failed ({rc}: '
                           f'{err(rc).decode()})')
    launches[op] += 1
    if design is not None:
        design_launches[op, design] += 1
