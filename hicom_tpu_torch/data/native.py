"""ctypes bindings for the native preprocessing library.

``native/libhicom_preprocess.so`` provides a multithreaded C++ implementation
of the host-side hot loop (uint8 frames → bicubic-antialias resize → normalize
→ CHW float32). Falls back to the PIL path transparently when the library
isn't built (``make -C native``). A copy of ``hicom_tpu/data/native.py`` over
the same committed library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                        "native", "libhicom_preprocess.so")


def load_library(build_if_missing: bool = True):
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path) and build_if_missing:
        try:
            subprocess.run(["make", "-C", os.path.dirname(path)], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.hicom_preprocess_frames.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.hicom_preprocess_frames.restype = None
    lib.hicom_expand2square.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.hicom_expand2square.restype = None
    _LIB = lib
    return lib


def native_available() -> bool:
    return load_library() is not None


def preprocess_frames(
    frames: np.ndarray,  # (n, h, w, 3) uint8 RGB
    out_size: int,
    image_mean: Sequence[float],
    image_std: Sequence[float],
    rescale: float = 1 / 255,
    num_threads: Optional[int] = None,
) -> np.ndarray:
    """→ (n, 3, out_size, out_size) float32, PIL-bicubic-equivalent."""
    lib = load_library()
    assert lib is not None, "native library unavailable; build with make -C native"
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w, c = frames.shape
    assert c == 3
    out = np.empty((n, 3, out_size, out_size), dtype=np.float32)
    mean = np.asarray(image_mean, dtype=np.float32)
    std = np.asarray(image_std, dtype=np.float32)
    if num_threads is None:
        num_threads = min(os.cpu_count() or 1, max(1, n))
    lib.hicom_preprocess_frames(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, out_size, ctypes.c_float(rescale),
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads,
    )
    return out


def expand2square(image: np.ndarray, background: Sequence[int]) -> np.ndarray:
    """(h, w, 3) uint8 → (side, side, 3) uint8, centered pad."""
    lib = load_library()
    assert lib is not None
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, _ = image.shape
    side = max(h, w)
    out = np.empty((side, side, 3), dtype=np.uint8)
    bg = np.asarray(background, dtype=np.uint8)
    lib.hicom_expand2square(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        bg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out
