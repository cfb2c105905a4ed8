#!/usr/bin/env python3
"""The closed loop of ``chip_smoke.py`` (``[closed-loop]``) at other learning rates, epochs and serving modes.

    python3 scripts/torch_loop_lr.py 1e-4:12:fp 3e-6:12:fp,int8_weight_only

Runs on one CUDA card. Builds the kernels, then for each ``lr:epochs:modes``
argument runs ``chip_smoke.closed_loop_phase`` with ``LOOP_LR``,
``LOOP_EPOCHS`` and ``LOOP_MODES`` set to it: the port's selftest loop at
HICom-7B width with 2 tower and 2 decoder layers, whose ``[closed-loop]``
lines give each stage's step time and loss curve, the accuracy and each
mode's. A setting that fails the phase's gates prints its traceback and the
answer files, and the script goes on to the next; it exits non-zero if any
failed. The first line is the card's name and power limit.
"""

from __future__ import annotations

import glob
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(specs) -> int:
    import chip_smoke as cs
    from hicom_tpu_torch.ops import cuda_build

    card = cs.card_line()
    print(card, flush=True)
    cuda_build.build_all()
    failed = 0
    for spec in specs:
        lr, epochs, modes = spec.split(":")
        cs.LOOP_LR, cs.LOOP_EPOCHS, cs.LOOP_MODES = float(lr), int(epochs), modes.split(",")
        t0 = time.perf_counter()
        try:
            cs.closed_loop_phase(card)
            print(f"PASS {spec} {time.perf_counter() - t0:.1f} s", flush=True)
        except AssertionError:
            failed += 1
            traceback.print_exc()
            print(f"FAIL {spec} {time.perf_counter() - t0:.1f} s", flush=True)
            for f in sorted(glob.glob(os.path.join(ROOT, "build", "chip_smoke_loop", "loop", "eval*", "*.json"))):
                with open(f) as fh:
                    print(f, fh.read()[:3000], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
