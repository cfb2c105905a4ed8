#!/usr/bin/env python3
"""Run modes of the port's bench (``python3 -m hicom_tpu_torch.bench``) in
turn on one card, each ``--repeats`` times, and gather their JSON lines.

    python3 scripts/torch_bench_modes.py                        # every mode, twice
    python3 scripts/torch_bench_modes.py --modes default,decode --repeats 2

The modes run round-robin (every mode once, then every mode again), each in
a process of its own. Each run's last JSON line goes to ``--out`` (one line
per run, with the mode, the round, and the run's seconds) and its stderr to
``<out>.<mode>.<round>.log``; a summary prints the card's name and power
limit, then each mode's value per round, their spread (largest less
smallest over the median) and, for the prefill modes, the bf16 arm's.
A run that fails stops the script with its exit code.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {
    "default": [],
    "batch1": ["--batch", "1"],
    "7b": ["--model", "7b"],
    "image32": ["--modal", "image", "--batch", "32"],
    "frames64": ["--frames", "64"],
    "decode": ["--decode"],
    "decode-kv-int8": ["--decode", "--kv-int8"],
    "train": ["--train"],
    "train-7b-bits4": ["--train", "--model", "7b", "--bits", "4"],
    "from-disk": ["--from-disk"],
    "from-disk-host": ["--from-disk", "--host-preprocess"],
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=",".join(MODES), help=f"comma list of {', '.join(MODES)}")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench_modes.jsonl"))
    ap.add_argument("--timeout", type=float, default=900, help="seconds allowed to one run")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    unknown = sorted(set(modes) - set(MODES))
    if unknown:
        ap.error(f"unknown modes {unknown}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    card = card_line()
    print(card, flush=True)
    results = {m: [] for m in modes}
    with open(args.out, "w") as out:
        for rnd in range(args.repeats):
            for mode in modes:
                t0 = time.perf_counter()
                proc = subprocess.run([sys.executable, "-m", "hicom_tpu_torch.bench"] + MODES[mode], cwd=ROOT,
                                      capture_output=True, text=True, timeout=args.timeout)
                seconds = time.perf_counter() - t0
                with open(f"{args.out}.{mode}.{rnd}.log", "w") as f:
                    f.write(proc.stderr)
                if proc.returncode != 0:
                    print(f"{mode} round {rnd} exited {proc.returncode}:\n{proc.stderr[-4000:]}", flush=True)
                    return proc.returncode
                res = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
                out.write(json.dumps({"mode": mode, "round": rnd, "seconds": round(seconds, 1), "card": card,
                                      "result": res}) + "\n")
                out.flush()
                results[mode].append(res)
                print(f"{mode} round {rnd} ({seconds:.1f} s): {json.dumps(res)}", flush=True)
    print(f"summary | {card}")
    for mode, runs in results.items():
        for key in ("value", "bf16_frames_per_sec"):
            vals = [r["value"] if key == "value" else r["detail"].get(key) for r in runs]
            if None in vals:
                continue
            mid = sorted(vals)[len(vals) // 2]
            print(f"{mode} {key}: {vals} spread {(max(vals) - min(vals)) / mid:.4f} | peak GB "
                  f"{[r['detail'].get('peak_gb' if key == 'value' else 'bf16_peak_gb') for r in runs]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
