#!/usr/bin/env python3
"""The tensor-parallel serving and data-parallel eval phases of ``chip_smoke.py`` alone, on its HICom-7B.

    python3 scripts/torch_mesh_serve_phases.py

Runs on one CUDA card: builds the kernels and ``[slice]``'s model (HICom-7B
at full width and depth, bf16, seeded weights), runs ``[serve-engine]`` on it
(which sets the decoder's norms to 1 and leaves its requests and graphed
streams), then ``[mesh-serve]`` (``ServeEngine(mesh=world_mesh())`` at tp 1,
graphed, with the tp collectives captured in the round graphs) and
``[eval-dp]`` (``shard_for_eval`` and ``mm_infer_batch``) in a one-rank NCCL
group. The lines are ``chip_smoke.py``'s; any mismatch raises. The first line
is the card's name and power limit.
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
        print("torch_mesh_serve_phases: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all()
    cfg = cs.serving_config()
    model = build_model(cfg, device="cuda", seed=0)
    hc = HICom(config=cfg, model=model, eos_token_id=cfg.text_config.eos_token_id, cache_len=4096)
    _, single = cs.make_requests(cfg)
    hc.generate(**single, max_new_tokens=2)  # warm-up: cuBLAS handles, library loads
    t0 = time.perf_counter()
    cs.serve_engine_phase(card, hc)
    t1 = time.perf_counter()
    launches = cs.group_phases(card, hc, cs.SLICE_C_PHASES)
    cs.log(f"[time] serve-engine {t1 - t0:.1f} s, mesh-serve and eval-dp {time.perf_counter() - t1:.1f} s | "
           f"launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
