"""Build and load the hand-written Hopper kernels of ``hicom_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with ``nvcc`` for
``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` beside the package (the hash
covers the source and the ``csrc`` headers it includes, so an edited source or
header rebuilds) and loaded with ``ctypes``. Nothing
is built or loaded at import: the first launch builds what it needs, and
:func:`build_all` builds every kernel at once, one ``nvcc`` process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_fwd", "flash_bwd", "flash_decode", "local_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str):
    """``csrc/<name>.cu`` and the headers beside it that it includes with
    quotes, recursively, in include order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [h for h in (path.parent / inc for inc in _INCLUDE.findall(path.read_text())) if h.exists()]
    return seen


def _target(name: str) -> Path:
    digest = hashlib.sha1()
    for path in _sources(name):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=SOURCES, verbose: bool = False) -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds per source
    (0.0 for one already built). ``verbose`` adds ``-Xptxas -v`` and prints
    the compiler's report of registers and shared memory."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    start = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if verbose and log:
            print(f"[{name}.cu]\n{log}", flush=True)
        os.replace(tmp, _target(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib


def c_function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """``symbol`` of ``csrc/<name>.cu`` with its C signature declared."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = list(argtypes), restype
    return fn


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what} failed with CUDA error {status}")
