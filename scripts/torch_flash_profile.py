#!/usr/bin/env python3
"""Device time of the port's flash kernels, kernel by kernel, at the main path's shapes.

    python3 scripts/torch_flash_profile.py [--root DIR] [--iters 20] [--cases K1,K2]

Runs on one CUDA card. Each case calls its wrapper (``fullblock_attention``,
``flash_forward``, K5's ``_launch_dq``, K6's ``_launch_dkv``, ``flash_decode``
or ``fused_tile_attention``) ``--iters`` times under
torch.profiler after a warm-up, and prints every CUDA kernel's mean device
time per call, so a split launch shows its main kernel and its merge or sum
pass apart, and the sum beside the CUDA-event time of the same calls (which
also holds launch gaps). The cases past head dim 256 (labels "wide ...", in
bf16 and fp32: K1 at d 288 over 128 rows of 729 and at d 320 / 512 / 1,024
over 64, K2 / K5 / K6 at [hd512]'s prefill and at 8 / 2 heads of 320 and 4 /
1 of 1,024, K5 there also forced to 3 splits) are ``--cases wide``; the bf16
instances at padded 192 and 256 (K1 over 64 rows of 729, K2 at [hd256]'s
prefill, 14 / 2 heads of 256, and with heads of 192) are ``--cases
d192,d256``. The last line is the card's name and power limit.
``--root`` imports ``hicom_tpu_torch`` from another checkout (its kernels
build into that checkout's ``build/``), so two versions can be timed in turns
in one call on one card. ``--cases`` keeps the cases whose label contains one
of the given words, and makes only their inputs. Kernels build on first use,
inside the warm-up.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def cases(torch, fa, fd, la, want):
    """(label, call) pairs at the shapes chip_smoke.py times, for the labels
    that ``want`` keeps; the inputs of the others are not made."""
    gen = torch.Generator("cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def any_of(*labels):
        return any(want(label) for label in labels)

    out = []
    for rows in (512, 1024):  # the tower: one 32-frame request, the train step's two
        if want(f"K1 tower {rows} rows"):
            q, k, v = rn(rows, 729, 72), rn(rows, 729, 72), rn(rows, 729, 72)
            out.append((f"K1 tower {rows} rows", lambda q=q, k=k, v=v: fa.fullblock_attention(q, k, v, 72**-0.5)))
    splits = (1, 2, 4, 5, 6, 7)  # the decoder's K6 with other split counts than dkv_splits' 3
    if any_of("K2 prefill", "K5 prefill", "K6 prefill", *(f"K6 prefill split {n}" for n in splits)):
        q, k, v = rn(2, 28, 743, 128), rn(2, 4, 743, 128), rn(2, 4, 743, 128)
        kl = torch.tensor([743, 700], device="cuda", dtype=torch.int32)
        out.append(("K2 prefill", lambda: fa.flash_forward(q, k, v, kl, 128**-0.5, 0.0, True)))
        do = rn(2, 28, 743, 128)
        o, lse = fa.flash_forward(q, k, v, kl, 128**-0.5, 0.0, True)
        ops_prefill = fa.backward_operands(q, k, v, kl, o, lse, do)
        out.append(("K5 prefill", lambda: fa._launch_dq(*ops_prefill, 128**-0.5, 0.0, True)))
        out.append(("K6 prefill", lambda: fa._launch_dkv(*ops_prefill, 128**-0.5, 0.0, True)))
        for n in splits:
            out.append((f"K6 prefill split {n}",
                        lambda n=n: fa._launch_dkv(*ops_prefill, 128**-0.5, 0.0, True, n_split=n)))
    if any_of("K2 1.5b prefill", "K5 1.5b prefill", "K6 1.5b prefill"):  # the 1.5B decoder: 12 / 2 heads
        q5, k5, v5, do5 = rn(2, 12, 743, 128), rn(2, 2, 743, 128), rn(2, 2, 743, 128), rn(2, 12, 743, 128)
        kl5 = torch.tensor([743, 700], device="cuda", dtype=torch.int32)
        out.append(("K2 1.5b prefill", lambda: fa.flash_forward(q5, k5, v5, kl5, 128**-0.5, 0.0, True)))
        o5, lse5 = fa.flash_forward(q5, k5, v5, kl5, 128**-0.5, 0.0, True)
        ops_15b = fa.backward_operands(q5, k5, v5, kl5, o5, lse5, do5)
        out.append(("K5 1.5b prefill", lambda: fa._launch_dq(*ops_15b, 128**-0.5, 0.0, True)))
        out.append(("K6 1.5b prefill", lambda: fa._launch_dkv(*ops_15b, 128**-0.5, 0.0, True)))
    if any_of("K2 global b1", "K2 global b2", "K5 global b2", "K6 global b2"):
        for b in (1, 2):
            qg, kg, vg = rn(b, 9, 32, 128), rn(b, 9, 23328, 128), rn(b, 9, 23328, 128)
            out.append((f"K2 global b{b}", lambda qg=qg, kg=kg, vg=vg: fa.flash_forward(qg, kg, vg, None, 128**-0.5)))
        dog = rn(2, 9, 32, 128)
        og, lseg = fa.flash_forward(qg, kg, vg, None, 128**-0.5)
        ops_global = fa.backward_operands(qg, kg, vg, None, og, lseg, dog)
        out.append(("K5 global b2", lambda: fa._launch_dq(*ops_global, 128**-0.5, 0.0, False)))
        out.append(("K6 global b2", lambda: fa._launch_dkv(*ops_global, 128**-0.5, 0.0, False)))
    if want("K6 tower"):
        qt, kt, vt, dot = (rn(512, 1, 729, 72) for _ in range(4))  # the tower's rows, off the stage-2 path
        ot, lset = fa.fullblock_attention(qt[:, 0], kt[:, 0], vt[:, 0], 72**-0.5)
        ops_tower = fa.backward_operands(qt, kt, vt, None, ot[:, None], lset[:, None], dot)
        out.append(("K6 tower", lambda: fa._launch_dkv(*ops_tower, 72**-0.5, 0.0, False)))
    if any_of("K3 decode b1", "K3 decode b2"):
        # decode over a 4096-slot cache: the single request (b 1) and the batched one (b 2)
        slot = torch.arange(4096, device="cuda")
        bitmap = torch.stack([slot < 760, (slot < 700) | ((slot >= 743) & (slot < 760))])
        qd, kd, vd = rn(2, 28, 1, 128), rn(2, 4, 4096, 128), rn(2, 4, 4096, 128)
        for b in (1, 2):
            out.append((f"K3 decode b{b}", lambda b=b: fd.flash_decode(qd[:b], kd[:b], vd[:b], bitmap[:b])))
    # the local compressor's tiles in the main path's call form (Python-float scale and bias): one request
    # (b 1) and the batched one (b 2, folded into the frame axis)
    for b in (1, 2):
        if want(f"K4 local b{b}"):
            key, val, qq = rn(32 * b, 27, 27, 1152), rn(32 * b, 27, 27, 1152), rn(8 * b, 9, 9, 1152)
            out.append((f"K4 local b{b}", lambda key=key, val=val, qq=qq:
                        la.fused_tile_attention(qq, key, val, (4, 3, 3), 1152**-0.5, 0.0)))
    # the CLIP and anyres configurations: K1 over CLIP-L/336's 577 tokens (d 64) and so400m over an anyres
    # image's 16 crops; K2 on the anyres prefill (7,333 tokens, 7,278 valid) and the CLIP global
    # compressor; K3 over the anyres request's 8,192-slot cache; K4 at qk 768 / dv 1024; K5/K6 at the
    # anyres train step (2 rows of 7,333 tokens, 7,333 and 7,310 valid)
    if want("K1 clip"):
        qc, kc, vc = rn(512, 577, 64), rn(512, 577, 64), rn(512, 577, 64)
        out.append(("K1 clip", lambda: fa.fullblock_attention(qc, kc, vc, 64**-0.5)))
    if want("K1 anyres crops"):
        qa, ka, va = rn(256, 729, 72), rn(256, 729, 72), rn(256, 729, 72)
        out.append(("K1 anyres crops", lambda: fa.fullblock_attention(qa, ka, va, 72**-0.5)))
    if want("K2 anyres prefill"):
        qp, kp, vp = rn(1, 28, 7333, 128), rn(1, 4, 7333, 128), rn(1, 4, 7333, 128)
        klp = torch.tensor([7278], device="cuda", dtype=torch.int32)
        out.append(("K2 anyres prefill", lambda: fa.flash_forward(qp, kp, vp, klp, 128**-0.5, 0.0, True)))
    if want("K2 clip global"):
        qcg, kcg, vcg = rn(1, 8, 32, 128), rn(1, 8, 18432, 128), rn(1, 8, 18432, 128)
        out.append(("K2 clip global", lambda: fa.flash_forward(qcg, kcg, vcg, None, 128**-0.5)))
    if want("K3 anyres decode"):
        slot = torch.arange(8192, device="cuda")
        bm = ((slot < 7278) | ((slot >= 7333) & (slot < 7341)))[None]
        qx, kx, vx = rn(1, 28, 1, 128), rn(1, 4, 8192, 128), rn(1, 4, 8192, 128)
        out.append(("K3 anyres decode", lambda: fd.flash_decode(qx, kx, vx, bm)))
    if want("K4 clip"):
        kc4, vc4, qc4 = rn(32, 24, 24, 768), rn(32, 24, 24, 1024), rn(8, 8, 8, 768)
        out.append(("K4 clip", lambda: la.fused_tile_attention(qc4, kc4, vc4, (4, 3, 3), 768**-0.5, 0.0)))
    if any_of("K5 anyres train", "K6 anyres train"):
        qy, ky, vy, doy = rn(2, 28, 7333, 128), rn(2, 4, 7333, 128), rn(2, 4, 7333, 128), rn(2, 28, 7333, 128)
        kly = torch.tensor([7333, 7310], device="cuda", dtype=torch.int32)
        oy, lsey = fa.flash_forward(qy, ky, vy, kly, 128**-0.5, 0.0, True)
        ops_anyres = fa.backward_operands(qy, ky, vy, kly, oy, lsey, doy)
        out.append(("K5 anyres train", lambda: fa._launch_dq(*ops_anyres, 128**-0.5, 0.0, True)))
        out.append(("K6 anyres train", lambda: fa._launch_dkv(*ops_anyres, 128**-0.5, 0.0, True)))
    # the bf16 forward's warp-specialised instances (flash_fwd.cu at padded 192 and 256): K1 over 64 rows of 729,
    # K2 at [hd256]'s prefill (b 2, 14 / 2 heads of 256, 743 tokens, causal, lengths 743 / 700) and at 192
    for d in (192, 256):
        if want(f"K1 d{d} 64 rows"):
            q1, k1, v1 = rn(64, 729, d), rn(64, 729, d), rn(64, 729, d)
            out.append((f"K1 d{d} 64 rows",
                        lambda q1=q1, k1=k1, v1=v1, d=d: fa.fullblock_attention(q1, k1, v1, d**-0.5)))
        if want(f"K2 prefill 14/2 d{d}"):
            q2, k2, v2 = rn(2, 14, 743, d), rn(2, 2, 743, d), rn(2, 2, 743, d)
            kl2 = torch.tensor([743, 700], device="cuda", dtype=torch.int32)
            out.append((f"K2 prefill 14/2 d{d}", lambda q2=q2, k2=k2, v2=v2, kl2=kl2, d=d:
                        fa.flash_forward(q2, k2, v2, kl2, d**-0.5, 0.0, True)))
    # past head dim 256 (flash_wide.cu, flash_wide_f32.cu), in bf16 and fp32: K1 over [hd512]'s tower rows (d 288,
    # 128 rows of 729) and over 64 rows at d 320 / 512 / 1,024; K2, K5 and K6 at [hd512]'s prefill (b 2, 7 / 1
    # heads of 512, 743 tokens, causal, lengths 743 / 700) and with 8 / 2 heads of 320 and 4 / 1 of 1,024
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        def rw(*shape, dtype=dtype):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        for d, rows in ((288, 128), (320, 64), (512, 64), (1024, 64)):
            if want(f"wide K1 d{d} {tag}"):
                qw, kw, vw = rw(rows, 729, d), rw(rows, 729, d), rw(rows, 729, d)
                out.append((f"wide K1 d{d} {tag}",
                            lambda qw=qw, kw=kw, vw=vw, d=d: fa.fullblock_attention(qw, kw, vw, d**-0.5)))
        for d, H, KVH in ((512, 7, 1), (320, 8, 2), (1024, 4, 1)):
            names = [f"wide {k} d{d} {tag}" for k in ("K2", "K5", "K6", "K5 split 3")]
            if not any_of(*names):
                continue
            qw, kw, vw, dow = rw(2, H, 743, d), rw(2, KVH, 743, d), rw(2, KVH, 743, d), rw(2, H, 743, d)
            klw = torch.tensor([743, 700], device="cuda", dtype=torch.int32)
            out.append((names[0], lambda qw=qw, kw=kw, vw=vw, klw=klw, d=d:
                        fa.flash_forward(qw, kw, vw, klw, d**-0.5, 0.0, True)))
            ow, lsew = fa.flash_forward(qw, kw, vw, klw, d**-0.5, 0.0, True)
            opw = fa.backward_operands(qw, kw, vw, klw, ow, lsew, dow)
            out.append((names[1], lambda opw=opw, d=d: fa._launch_dq(*opw, d**-0.5, 0.0, True)))
            out.append((names[2], lambda opw=opw, d=d: fa._launch_dkv(*opw, d**-0.5, 0.0, True)))
            if d == 512:
                out.append((names[3], lambda opw=opw, d=d: fa._launch_dq(*opw, d**-0.5, 0.0, True, n_split=3)))
    return [(label, call) for label, call in out if want(label)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cases", default="", help="comma-separated words; a case runs when its label holds one")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_flash_profile: no CUDA device", file=sys.stderr)
        return 2
    from hicom_tpu_torch.ops import flash_attention as fa
    from hicom_tpu_torch.ops import flash_decode as fd
    from hicom_tpu_torch.ops import local_attn as la

    print(f"[profile-flash] hicom_tpu_torch from {os.path.dirname(fa.__file__)}", flush=True)
    words = [w for w in args.cases.split(",") if w]
    for label, call in cases(torch, fa, fd, la, lambda label: not words or any(w in label for w in words)):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            call()
        end.record()
        end.synchronize()
        event_us = 1e3 * start.elapsed_time(end) / args.iters
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        times = sorted(((getattr(e, "self_device_time_total", 0.0) / args.iters, e.key) for e in kernels), reverse=True)
        parts = " | ".join(f"{name[:70]} {us:.2f} us" for us, name in times if us > 0)
        print(f"[profile-flash] {label}: device {sum(us for us, _ in times):.2f} us per call (events "
              f"{event_us:.2f} us) | {parts}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
