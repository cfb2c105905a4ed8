#!/usr/bin/env python3
"""The mesh phases of ``chip_smoke.py`` alone, with the phases they are held to.

    python3 scripts/torch_mesh_phases.py

Runs on one CUDA card: builds the kernels, then ``[train]`` (3 stage-2 steps
of HICom-7B at full width and depth, whose losses and grad norms it keeps),
``[mesh-train]`` (the same steps through the (1, 1, 1) mesh in a one-rank
NCCL group, bit-equal to them, then one step under torch.profiler),
``[cli]`` (the trainer's CLI from files at 7B width with 2 + 2 layers) and
``[mesh-cli]`` (its stage 2 again under ``torch.distributed.run``). Each
phase's lines are ``chip_smoke.py``'s, followed by its wall time; any
mismatch raises. The first line is the card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from hicom_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("torch_mesh_phases: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        cs.log(f"[time] {name} {time.perf_counter() - t0:.1f} s")
        return out

    _, record = timed("train", cs.train_phase, card)
    timed("mesh-train", cs.mesh_train_phase, card, record)
    timed("mesh-cli", cs.mesh_cli_phase, card, timed("cli", cs.cli_phase, card))
    return 0


if __name__ == "__main__":
    sys.exit(main())
