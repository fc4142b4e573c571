"""Native (C++) host-side data pipeline, bound with ctypes (counterpart of
``awsegbench/native``).

``awseg_host.cpp`` is the port's own copy of the JAX package's source: PNG
decode, cv2-convention uint8 resize and a threaded batch pack. It is built
with ``g++ … -lz`` at first use into ``build/libawseg_host.so`` beside it
(which git ignores). The dataset reads images through it only
where ``cv2`` is missing, and the loader stacks batches with it; where it
cannot be built, they fall back as the JAX package does (a warning, then
the synthetic fallback for an image, ``np.stack`` for a batch).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / 'awseg_host.cpp'
_LIB = _HERE / 'build' / 'libawseg_host.so'

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _build() -> bool:
    """Compile into a temporary file and rename it into place, so processes
    building at once (test workers) never load a half-written library."""
    _LIB.parent.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=_LIB.parent)
    os.close(fd)
    try:
        cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17',
               str(_SRC), '-o', tmp, '-lz', '-lpthread']
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning(f"awseg_host native build failed: {e}")
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not _LIB.exists()
                or _LIB.stat().st_mtime < _SRC.stat().st_mtime):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError as e:
            logger.warning(f"awseg_host load failed: {e}")
            return None

        lib.awseg_png_info.restype = ctypes.c_int
        lib.awseg_png_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.awseg_png_decode.restype = ctypes.c_int
        lib.awseg_png_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        for name in ('awseg_resize_nearest_u8', 'awseg_resize_bilinear_u8'):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_int32]
        lib.awseg_pack_batch.restype = None
        lib.awseg_pack_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def png_decode(data: bytes) -> Optional[np.ndarray]:
    """Decode 8-bit non-interlaced PNG bytes → [H, W, C] (or [H, W]) uint8."""
    lib = load()
    if lib is None:
        return None
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    ch = ctypes.c_int32()
    rc = lib.awseg_png_info(data, len(data), ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(ch))
    if rc != 0:
        return None
    out = np.empty((h.value, w.value, ch.value), dtype=np.uint8)
    rc = lib.awseg_png_decode(data, len(data),
                              out.ctypes.data_as(ctypes.c_void_p),
                              h.value, w.value, ch.value)
    if rc != 0:
        return None
    return out[..., 0] if ch.value == 1 else out


def imread(path: str, grayscale: bool = False) -> Optional[np.ndarray]:
    """PNG file → uint8 array (RGB order; alpha dropped; gray stays 2-D)."""
    try:
        with open(path, 'rb') as f:
            img = png_decode(f.read())
    except OSError:
        return None
    if img is None:
        return None
    if img.ndim == 3 and img.shape[-1] == 4:
        img = img[..., :3]
    if img.ndim == 3 and img.shape[-1] == 2:  # gray+alpha
        img = img[..., 0]
    if grayscale and img.ndim == 3:
        # cv2's fixed-point RGB → gray
        xi = img.astype(np.int32)
        img = ((xi[..., 0] * 4899 + xi[..., 1] * 9617 + xi[..., 2] * 1868 +
                (1 << 13)) >> 14).astype(np.uint8)
    return img


def resize_u8(img: np.ndarray, out_hw: tuple[int, int],
              nearest: bool = False) -> Optional[np.ndarray]:
    """cv2-convention uint8 resize (bilinear default, nearest for labels)."""
    lib = load()
    if lib is None:
        return None
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    img = np.ascontiguousarray(img)
    h, w, ch = img.shape
    dh, dw = out_hw
    out = np.empty((dh, dw, ch), dtype=np.uint8)
    fn = lib.awseg_resize_nearest_u8 if nearest else lib.awseg_resize_bilinear_u8
    fn(img.ctypes.data_as(ctypes.c_void_p), h, w,
       out.ctypes.data_as(ctypes.c_void_p), dh, dw, ch)
    return out[..., 0] if squeeze else out


def pack_batch(items: Sequence[np.ndarray], n_threads: int = 4
               ) -> Optional[np.ndarray]:
    """Threaded gather of equally-shaped arrays into one [N, ...] batch."""
    lib = load()
    if lib is None:
        return None
    items = [np.ascontiguousarray(a) for a in items]
    n = len(items)
    if any(a.shape != items[0].shape or a.dtype != items[0].dtype
           for a in items):
        raise ValueError('pack_batch: items differ in shape or dtype')
    item_bytes = items[0].nbytes
    out = np.empty((n,) + items[0].shape, dtype=items[0].dtype)
    ptrs = (ctypes.c_char_p * n)(*[
        ctypes.cast(a.ctypes.data_as(ctypes.c_void_p), ctypes.c_char_p)
        for a in items])
    lib.awseg_pack_batch(ptrs, n, item_bytes,
                         out.ctypes.data_as(ctypes.c_void_p), n_threads)
    return out
