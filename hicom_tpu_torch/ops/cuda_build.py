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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_fwd", "flash_fwd_f32", "flash_bwd", "flash_bwd_f32", "flash_wide", "flash_wide_f32", "flash_decode",
           "local_attn")
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


_PLAIN = (torch.Tensor, torch.nn.Parameter, type(None), float, int)


def plain_operands(what: str, *operands) -> None:
    """Raise if a DTensor reaches a kernel wrapper: a launch takes raw pointers
    and shapes, and a DTensor's are its wrapper's, not its local shard's. A
    sharded model hands its kernels local tensors (``parallel/sharding.py``).
    A plain tensor, a parameter or a number passes on its type alone, so a
    launch pays no import and no ``isinstance`` walk for it."""
    for t in operands:
        if type(t) not in _PLAIN and isinstance(t, torch.Tensor):
            from torch.distributed.tensor import DTensor

            if isinstance(t, DTensor):
                raise TypeError(f"{what} takes plain local tensors, not DTensors")


class PlainRoute:
    """Calls on a device that a kernel's contract sent to the plain path, by
    kernel. Only K3 has such a route: the decoder asks ``takes_decode_kernel``
    before a one-token step, from shapes and dtypes, and counts here each step
    it takes to the plain masked attention, which is JAX's default XLA decode
    (its Pallas decode kernel is opt-in). The other wrappers raise for device
    operands outside their contract. CPU tensors never count: their wrappers
    take the plain twin."""

    KERNELS = ("K3",)

    def __init__(self):
        self.counts = dict.fromkeys(self.KERNELS, 0)

    def add(self, kernel: str) -> None:
        self.counts[kernel] += 1

    def reset(self) -> None:
        self.counts = dict.fromkeys(self.KERNELS, 0)


plain_route = PlainRoute()


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what} failed with CUDA error {status}")
