#!/usr/bin/env python3
"""How far the flash forward (K2) and its plain version each are from the float64 answer on a long causal prefill.

    python3 scripts/torch_prefill_precision.py [--length 7333] [--valid 7278] [--seeds 1,2,3]

Runs on one CUDA card. For each seed it draws bf16 q, k, v of one row of
the 7B decoder's prefill (28 query and 4 KV heads, d 128, causal, a valid
length), runs the kernel (``flash_forward``) and its plain version
(``flash_reference``), and finds the element where the two differ most
against the kernel gate of ``chip_smoke.py`` (``agreement``: 2^-6 |ref| +
2^-5 rms). It computes the float64 answer of every head
(``chip_smoke.exact_prefill``) and prints the worst element on each side of
it, the gate's ratio, the rms of that element's row beside the whole
output's, and ``chip_smoke.float64_referee``'s reading: each side's largest
and rms error against float64. The last line is the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--length", type=int, default=7333)  # the [anyres] request's spliced prompt
    p.add_argument("--valid", type=int, default=7278)
    p.add_argument("--seeds", default="1,2,3")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_prefill_precision: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import agreement, exact_prefill, float64_referee
    from hicom_tpu_torch.ops.flash_attention import flash_forward, flash_reference

    L, n, H, KVH, d = args.length, args.valid, 28, 4, 128
    kl = torch.tensor([n], device="cuda", dtype=torch.int32)
    for seed in map(int, args.seeds.split(",")):
        gen = torch.Generator("cuda").manual_seed(seed)
        q, k, v = (torch.randn(1, h, L, d, generator=gen, device="cuda").to(torch.bfloat16) for h in (H, KVH, KVH))
        got = flash_forward(q, k, v, kl, d**-0.5, 0.0, True)[0][0, :, :n].float()
        ref = flash_reference(q, k, v, kl, d**-0.5, 0.0, True)[0][0, :, :n].float()
        exact = exact_prefill(q, k, v, kl)[0, :, :n]
        rms = ref.square().mean().sqrt()
        whole = (got - ref).abs() / (2**-6 * ref.abs() + 2**-5 * rms)
        h, row, col = (int(i) for i in torch.unravel_index(whole.argmax(), whole.shape))
        ek, ep, ulp, rk, rp, ok = float64_referee(got, ref, exact)
        print(f"seed {seed}: L {L}, valid {n} | worst element head {h} row {row} col {col}: kernel "
              f"{got[h, row, col].item():.6f}, plain {ref[h, row, col].item():.6f}, float64 "
              f"{exact[h, row, col].item():.6f} | gate ratio {agreement(got, ref)[1]:.3f} with the output's rms "
              f"{rms.item():.4g}; that row's rms {ref[:, row].square().mean().sqrt().item():.4g} | against float64: "
              f"max error kernel {ek:.4g}, plain {ep:.4g} (one bf16 ulp there {ulp:.4g}); rms error kernel "
              f"{rk:.4g}, plain {rp:.4g}; referee {'passes' if ok else 'fails'}", flush=True)
        del q, k, v, got, ref, whole, exact
        torch.cuda.empty_cache()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
