#!/usr/bin/env python3
"""Build the port's CUDA kernels and report, per kernel, its warpgroup MMAs and what serialises them.

    python3 scripts/torch_kernel_sass.py [--sources flash_bwd,flash_fwd]

Runs where ``nvcc`` and ``cuobjdump`` are (the machine with the card). It
builds the given ``hicom_tpu_torch/csrc`` sources with ptxas's report
(``-Xptxas -v``) and prints each kernel's registers, any spills, and any
"Potential Performance Loss" warning (C7514, C7518: ptxas serialised the
wgmma of a kernel). Then, for every kernel function of the built library's
SASS that has warpgroup MMAs, it prints the number of ``HGMMA``
instructions and of ``WARPGROUP.DEPBAR`` (a wait on the warpgroup's MMAs):
as many waits as products means each product ran alone.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hicom_tpu_torch.ops import cuda_build  # noqa: E402


def sass_counts(lib: str):
    """(kernel name, HGMMA count, WARPGROUP.DEPBAR count) for each function of the library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True, timeout=300).stdout
    rows, name, hgmma, depbar = [], None, 0, 0
    for line in sass.splitlines() + ["Function : <end>"]:
        if "Function :" in line:
            if name is not None:
                rows.append((name, hgmma, depbar))
            name, hgmma, depbar = line.split("Function :")[1].strip(), 0, 0
        elif "HGMMA" in line:
            hgmma += 1
        elif "WARPGROUP.DEPBAR" in line:
            depbar += 1
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sources", default="flash_bwd,flash_fwd", help="comma-separated csrc/<name>.cu stems")
    args = ap.parse_args()
    names = [n for n in args.sources.split(",") if n]
    for name in names:  # rebuild with the report even if a library is already there
        target = cuda_build._target(name)
        if target.exists():
            target.unlink()
    log = subprocess.run([sys.executable, "-c", "from hicom_tpu_torch.ops import cuda_build as c; "
                          f"c.build_all({tuple(names)!r}, verbose=True)"], capture_output=True, text=True,
                         cwd=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."), timeout=900)
    if log.returncode != 0:
        print(log.stdout + log.stderr)
        return 1
    kernel = None
    for line in log.stdout.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            kernel = entry.group(1)
        elif "Used" in line and "registers" in line:
            print(f"[ptxas] {kernel[:110]}: {line.split(':', 1)[1].strip()}")
        elif re.search(r"Performance Loss|C751[48]", line) or (re.search(r"[1-9]\d* bytes spill", line)):
            print(f"[ptxas] {line.strip()}")
    for name in names:
        print(f"[sass] {name}: kernel, HGMMA, WARPGROUP.DEPBAR")
        for kernel, hgmma, depbar in sass_counts(str(cuda_build._target(name))):
            if hgmma:
                print(f"[sass]   {kernel[:110]}  HGMMA {hgmma}  DEPBAR {depbar}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
