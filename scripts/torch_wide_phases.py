#!/usr/bin/env python3
"""The phases of ``chip_smoke.py`` that run attention past head dim 128, alone.

    python3 scripts/torch_wide_phases.py [--phases wide-kernels,hd256,hd512]

Runs on one CUDA card: builds the kernels, then (by default all three, in
this order) ``[wide-kernels]`` (phase 3's rows at head dims 192 and 256 and
past 256 in bf16 and fp32: ``chip_smoke.head_dim_checks``),
``[hd256]`` (HICom-7B with 14 / 2 decoder heads of 256 at 4 layers: 3
requests, greedy ids and logits against the plain path on the card, 2
stage-2 steps with step 1's gradients against the plain path's) and
``[hd512]`` (the same with 7 / 1 decoder heads of 512 and 4 tower heads of
288). Each phase's lines are ``chip_smoke.py``'s, followed by its wall time;
any mismatch raises. The first line is the card's name and power limit; the
last, where ``[wide-kernels]`` ran, the JSON list of its rows whose phase ran
too, each with that phase's launches, as ``chip_smoke.py`` reports them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PHASES = ("wide-kernels", "hd256", "hd512")


def main() -> int:
    import torch

    import chip_smoke as cs
    from hicom_tpu_torch.ops import cuda_build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES), help="comma-separated, of " + ", ".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    if not torch.cuda.is_available():
        print("torch_wide_phases: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.build_all()
    cs.log(f"[time] build {time.perf_counter() - t0:.1f} s")
    run = {"wide-kernels": lambda c: cs.kernel_checks(c, wide_only=True), "hd256": cs.hd256_phase,
           "hd512": cs.hd512_phase}
    results = {}
    for name in phases:
        t0 = cs.PHASE_START[0] = time.perf_counter()
        results[name] = cs.on_contract(name, run[name](card))
        cs.log(f"[time] {name} {time.perf_counter() - t0:.1f} s")
    rows = []
    for row, (kid, phase, rec) in results.get("wide-kernels", {}).items():
        if phase in results:
            rec["launches"] = results[phase].get(cs.KERNELS[kid][0], 0)
            if rec["launches"] <= 0:
                raise AssertionError(f"{row}: [{phase}] never launched {cs.KERNELS[kid][0]}")
            rows.append(rec)
    if rows:
        print(json.dumps({"kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
