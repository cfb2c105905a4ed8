#!/usr/bin/env python3
"""The fp32 phases of ``chip_smoke.py`` alone.

    python3 scripts/torch_fp32_phases.py [--phases kernels,fp32-serve,fp32-train,closed-loop]

Runs on one CUDA card: builds the kernels, then (by default all four, in
this order) ``[kernels]`` (every kernel row of the smoke's phase 3, the fp32
instances, forward and backward, and the new head-dim checks among them),
``[fp32-serve]`` (HICom-7B in fp32 at full width and depth against the plain
path on the card), ``[fp32-train]`` (3 stage-2 steps of HICom-7B in fp32,
step 1's gradients against the plain path's) and ``[closed-loop]`` (the
selftest loop at HICom-7B width, then the eval runner with ``--dtype
float32`` over its export). Each phase's lines are
``chip_smoke.py``'s, followed by its wall time; any mismatch raises. The first
line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PHASES = ("kernels", "fp32-serve", "fp32-train", "closed-loop")


def main() -> int:
    import torch

    import chip_smoke as cs
    from hicom_tpu_torch.ops import cuda_build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES), help="comma-separated, of " + ", ".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    if not torch.cuda.is_available():
        print("torch_fp32_phases: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.build_all()
    cs.log(f"[time] build {time.perf_counter() - t0:.1f} s")
    run = {"kernels": cs.kernel_checks, "fp32-serve": cs.fp32_serve_phase, "fp32-train": cs.fp32_train_phase,
           "closed-loop": cs.closed_loop_phase}
    for name in phases:
        t0 = cs.PHASE_START[0] = time.perf_counter()
        cs.on_contract(name, run[name](card))
        cs.log(f"[time] {name} {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
