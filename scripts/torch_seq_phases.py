#!/usr/bin/env python3
"""The sequence-parallel phases of ``chip_smoke.py`` alone, on its HICom-7B.

    python3 scripts/torch_seq_phases.py

Runs on one CUDA card: builds the kernels and ``[slice]``'s model (HICom-7B
at full width and depth, bf16, seeded weights, the decoder's norms at 1 as
``[serve-engine]`` leaves them), then ``[seq-parallel]`` in a one-rank NCCL
group: ``[long-video]`` (a 128-frame video through ``encode_long_video``,
and a 4-rank run's shares in turn, against ``encode_visual``),
``[ring-prefill]`` (16,384 tokens through ``ring_prefill`` against the
direct prefill, an 8-rank ring's blocks of one layer against one causal K2,
``_generate_ring`` against ``generate``) and ``[pipeline]``. The lines are
``chip_smoke.py``'s, followed by the phase's wall time; any mismatch raises.
The first line is the card's name and power limit.
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
    from hicom_tpu_torch.api import HICom, build_model
    from hicom_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("torch_seq_phases: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all()
    cfg = cs.serving_config()
    model = build_model(cfg, device="cuda", seed=0)
    cs.norms_at_one(model)
    hc = HICom(config=cfg, model=model, eos_token_id=cfg.text_config.eos_token_id, cache_len=4096)
    _, single = cs.make_requests(cfg)
    hc.generate(**single, max_new_tokens=2)  # warm-up: cuBLAS handles, library loads
    t0 = time.perf_counter()
    launches = cs.seq_parallel_phase(card, hc)
    cs.log(f"[time] seq-parallel {time.perf_counter() - t0:.1f} s | launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
