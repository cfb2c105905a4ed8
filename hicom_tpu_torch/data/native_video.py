"""ctypes bindings for the native video reader (decord analogue).

``native/libhicom_video.so`` decodes exactly the sampled frame indices from a
video container via libav (ffmpeg) with keyframe-aware seeking — the role
decord.VideoReader plays in the reference's loader
(reference ``mm_utils.py:574-644``). A copy of ``hicom_tpu/data/native_video.py``
over the same committed library. The surface mirrors decord:
``VideoReader(path)``, ``len()``, ``get_avg_fps()``, ``get_batch(indices)``.

Falls back transparently (``native_video_available()``) to the cv2 path in
``data/video.py`` when the library isn't built or libav is absent.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Sequence

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native", "libhicom_video.so")


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
    try:
        lib = ctypes.CDLL(path)
    except OSError:  # libav runtime missing
        return None
    lib.hicom_vr_open.argtypes = [ctypes.c_char_p]
    lib.hicom_vr_open.restype = ctypes.c_void_p
    lib.hicom_vr_meta.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.hicom_vr_meta.restype = None
    lib.hicom_vr_get_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
    lib.hicom_vr_get_batch.restype = ctypes.c_int
    lib.hicom_vr_close.argtypes = [ctypes.c_void_p]
    lib.hicom_vr_close.restype = None
    lib.hicom_vr_last_error.argtypes = []
    lib.hicom_vr_last_error.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def native_video_available() -> bool:
    return (os.environ.get("HICOM_NATIVE_VIDEO", "1") != "0"
            and load_library() is not None)


class VideoReader:
    """decord.VideoReader-shaped handle over the native libav reader."""

    def __init__(self, path: str):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native video library unavailable (make -C native)")
        self._lib = lib
        self._h = lib.hicom_vr_open(os.fspath(path).encode())
        if not self._h:
            raise IOError(f"cannot open video: {path} "
                          f"({lib.hicom_vr_last_error().decode()})")
        fps = ctypes.c_double()
        n = ctypes.c_int64()
        w = ctypes.c_int()
        h = ctypes.c_int()
        lib.hicom_vr_meta(self._h, ctypes.byref(fps), ctypes.byref(n),
                          ctypes.byref(w), ctypes.byref(h))
        self._fps = fps.value
        self._n = int(n.value)
        self.width, self.height = int(w.value), int(h.value)
        if self._n <= 0:
            self.close()
            raise IOError(f"video has no decodable frames: {path}")

    def __len__(self) -> int:
        return self._n

    def get_avg_fps(self) -> float:
        return self._fps

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """→ (len(indices), h, w, 3) uint8 RGB, in the given order.

        Mirrors the reference loader's tolerance: indices past the decodable
        end repeat the last decoded frame (cv2 fallback does the same)."""
        if self._h is None:
            raise ValueError("reader is closed")
        idx = [int(i) for i in indices]
        wanted = sorted(set(idx))
        n = len(wanted)
        arr = np.asarray(wanted, dtype=np.int64)
        out = np.empty((n, self.height, self.width, 3), dtype=np.uint8)
        got = np.zeros((n,), dtype=np.uint8)
        rc = self._lib.hicom_vr_get_batch(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            got.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc < 0:
            raise IOError(f"decode failed: {self._lib.hicom_vr_last_error().decode()}")
        if not got.any():
            raise IOError("failed to decode any requested frame")
        # fill-forward missing tail frames (stream ended early)
        last_ok = 0
        for i in range(n):
            if got[i]:
                last_ok = i
            else:
                out[i] = out[last_ok]
        by_index = {w: out[i] for i, w in enumerate(wanted)}
        return np.stack([by_index[i] for i in idx])

    def close(self):
        if getattr(self, "_h", None):
            self._lib.hicom_vr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
