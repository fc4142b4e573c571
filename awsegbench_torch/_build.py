"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``csrc/build/``
the first time a wrapper needs it, then loaded with ``ctypes``. The library
file name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. A failed build raises with
nvcc's output.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = CSRC / 'build'

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# Per-source extra flags. The splat mask must equal its plain version bit
# for bit, so no multiply-add contraction may move a ``d2 <= r*r`` decision.
EXTRA_FLAGS = {'splat': ['-fmad=false']}
KERNELS = ('sr_attention', 'seg_head', 'splat')

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
    digest = hashlib.sha256(src.read_bytes() + ' '.join(flags).encode())
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


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        lib.awseg_error_string.argtypes = [ctypes.c_int]
        lib.awseg_error_string.restype = ctypes.c_char_p
        msg = lib.awseg_error_string(rc).decode()
        raise RuntimeError(f'{what}: CUDA launch failed ({rc}: {msg})')


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, for a launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
