#!/usr/bin/env python3
"""Drive the PyTorch port (hicom_tpu_torch) on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: every kernel of hicom_tpu_torch/csrc, one nvcc per source, in parallel;
  3. each kernel against its plain PyTorch version at the main path's shapes, in
     bf16, with its time, the plain version's, a PyTorch library call's where one
     computes the same function, and the card's bound for the same work;
  4. the main path at the full width of the released HICom-7B (SigLIP-so400m,
     local43_global32 with direct guide, Qwen2.5-7B in bf16, weights from a seed
     on the card): 3 requests of a 32-frame 384x384 video through
     ``HICom.generate`` (a right-padded batch of 2, then one alone), greedy, 16
     new tokens; every kernel's launch count must rise. Then, with 2 decoder and
     2 tower layers, the kernel path's last-token prefill logits against the
     plain path's.

Prints one line per check, then a JSON object with the kernels, then the
card's name and power limit, and last ``{"ok": true, "device": {...}}``. Any
failure exits non-zero before that last line. Without a CUDA device, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

# H100 data-sheet peaks (dense bf16 tensor-core FLOP/s, HBM bytes/s) by card name
PEAKS = {"PCIe": (756e12, 2.0e12), "NVL": (835e12, 3.9e12), "": (989e12, 3.35e12)}
SOURCES = {
    "fullblock_attention": ("hicom_tpu_torch/csrc/flash_fwd.cu", "hicom_tpu/ops/flash_attention.py:141"),
    "flash_forward": ("hicom_tpu_torch/csrc/flash_fwd.cu", "hicom_tpu/ops/flash_attention.py:31"),
    "flash_decode": ("hicom_tpu_torch/csrc/flash_decode.cu", "hicom_tpu/ops/flash_decode.py:32"),
    "fused_tile_attention": ("hicom_tpu_torch/csrc/local_attn.cu", "hicom_tpu/ops/local_attn.py:26"),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def agreement(got, ref):
    """A kernel's output against its plain version's, both bf16.

    Each element may differ by 2^-6 |ref| + 2^-5 rms(ref): two bf16 ulps of
    its own value (both sides round the output; the kernel rounds or sums p at
    another running max than the plain version), plus a 32nd of the output's
    typical size for elements near zero, whose error is that of the row's sum
    of rounded terms. Returns (max abs error, worst error/tolerance, rms(ref),
    max |ref|); the check passes when the worst ratio is at most 1."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    rms = ref.square().mean().sqrt()
    ratio = (err / (2**-6 * ref.abs() + 2**-5 * rms)).max()
    return err.max().item(), ratio.item(), rms.item(), ref.abs().max().item()


def kernel_checks(card: str):
    """Phase 3: returns {entry name: record} for the JSON line."""
    import torch
    import torch.nn.functional as F

    from hicom_tpu_torch.ops.flash_attention import flash_forward, flash_reference, fullblock_attention
    from hicom_tpu_torch.ops.flash_decode import decode_reference, flash_decode
    from hicom_tpu_torch.ops.local_attn import fused_tile_attention, tile_reference

    peak_flops, peak_bw = next(v for k, v in PEAKS.items() if k in card)
    dev = "cuda"
    gen = torch.Generator(dev).manual_seed(1)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    records = {}

    def record(name, wrapper, kernel_fn, plain_fn, library_fn, flops, nbytes, valid=None):
        got, ref = kernel_fn(), plain_fn()
        got = got[0] if isinstance(got, tuple) else got
        ref = ref[0] if isinstance(ref, tuple) else ref
        if valid is not None:
            got, ref = got[valid], ref[valid]
        err, ratio, rms, top = agreement(got, ref)
        bound_c, bound_b = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        rec = dict(name=name, route="cuda", source=SOURCES[wrapper][0], replaces=SOURCES[wrapper][1],
                   launches=None, max_abs_err=err, ms=cuda_ms(kernel_fn), plain_ms=cuda_ms(plain_fn, iters=3),
                   bound_ms=max(bound_c, bound_b), bound_by="operations" if bound_c >= bound_b else "bytes",
                   library_ms=cuda_ms(library_fn) if library_fn is not None else None)
        records[name] = (wrapper, rec)
        log(f"[kernel] {name}: max_abs_err {err:.3g}, worst err/tol {ratio:.3f} (tol 2^-6|ref| + 2^-5 rms, "
            f"ref rms {rms:.3g}, max {top:.3g}) | kernel {rec['ms']:.4f} ms | plain "
            f"{rec['plain_ms']:.4f} ms | library {rec['library_ms'] if rec['library_ms'] is None else round(rec['library_ms'], 4)} ms"
            f" | bound {rec['bound_ms'] * 1e3:.1f} us ({rec['bound_by']})")
        if not ratio <= 1:
            raise AssertionError(f"{name}: kernel disagrees with its plain version (worst err/tol {ratio})")

    # K1: SigLIP tower self-attention, 32 frames x 16 heads, L = 729, d = 72
    bh, L, d = 32 * 16, 729, 72
    q, k, v = rn(bh, L, d), rn(bh, L, d), rn(bh, L, d)
    record("fullblock_attention[siglip 32f]", "fullblock_attention",
           lambda: fullblock_attention(q, k, v, d**-0.5),
           lambda: flash_reference(q[:, None], k[:, None], v[:, None], None, d**-0.5, 0.0, False)[0][:, 0],
           lambda: F.scaled_dot_product_attention(q, k, v, scale=d**-0.5),
           4 * bh * L * L * d, 4 * bh * L * d * 2 + bh * L * 4)
    del q, k, v

    # K2 prefill: 28 q / 4 kv heads, L = 743 (64-token bucket - 1 + 680), causal,
    # a right-padded row (kv_lengths 700) beside a full one
    b, H, KVH, L, d = 2, 28, 4, 743, 128
    lens = [743, 700]
    q, k, v = rn(b, H, L, d), rn(b, KVH, L, d), rn(b, KVH, L, d)
    kl = torch.tensor(lens, device=dev, dtype=torch.int32)
    pos = torch.arange(L, device=dev)
    mask = (pos[None, :] <= pos[:, None])[None, None] & (pos[None, None, None, :] < kl[:, None, None, None])
    valid = (pos[None, :] < kl[:, None])[:, None, :].expand(b, H, L)
    pairs = sum(int(np.minimum(n, np.arange(L) + 1).sum()) for n in lens)
    record("flash_forward[prefill 7b]", "flash_forward",
           lambda: flash_forward(q, k, v, kl, d**-0.5, 0.0, True),
           lambda: flash_reference(q, k, v, kl, d**-0.5, 0.0, True),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=d**-0.5, enable_gqa=True),
           4 * H * d * pairs, 2 * b * H * L * d * 2 + 2 * KVH * sum(lens) * d * 2 + b * H * L * 4, valid)
    del q, k, v, mask

    # K2 global compressor: 9 heads, 32 queries over 32 x 27 x 27 = 23,328 keys, d = 128
    H, Lq, Lk, d = 9, 32, 23328, 128
    q, k, v = rn(1, H, Lq, d), rn(1, H, Lk, d), rn(1, H, Lk, d)
    record("flash_forward[global 32f]", "flash_forward",
           lambda: flash_forward(q, k, v, None, d**-0.5, 0.0, False),
           lambda: flash_reference(q, k, v, None, d**-0.5, 0.0, False),
           lambda: F.scaled_dot_product_attention(q, k, v, scale=d**-0.5),
           4 * H * Lq * Lk * d, 2 * H * Lq * d * 2 + 2 * H * Lk * d * 2 + H * Lq * 4)
    del q, k, v

    # K3: decode over a 4096-slot cache, b = 2, ragged bitmaps (a padded prompt's
    # pad slots are invalid), bf16 cache and int8 cache + scales
    b, H, KVH, S, d = 2, 28, 4, 4096, 128
    slot = torch.arange(S, device=dev)
    bitmap = torch.stack([slot < 760, (slot < 700) | ((slot >= 743) & (slot < 760))])
    n_valid = int(bitmap.sum())
    q = rn(b, H, 1, d)
    kb, vb = rn(b, KVH, S, d), rn(b, KVH, S, d)
    record("flash_decode[bf16 cache]", "flash_decode",
           lambda: flash_decode(q, kb, vb, bitmap),
           lambda: decode_reference(q, kb, vb, bitmap, None, None, d**-0.5),
           lambda: F.scaled_dot_product_attention(q, kb, vb, attn_mask=bitmap[:, None, None, :], enable_gqa=True),
           4 * H * d * n_valid, 2 * b * H * d * 2 + n_valid * KVH * d * 2 * 2 + b * S)
    ki = torch.randint(-127, 128, (b, KVH, S, d), generator=gen, device=dev, dtype=torch.int8)
    vi = torch.randint(-127, 128, (b, KVH, S, d), generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand(b, KVH, S, generator=gen, device=dev) * 0.02
    vs = torch.rand(b, KVH, S, generator=gen, device=dev) * 0.02
    record("flash_decode[int8 cache]", "flash_decode",
           lambda: flash_decode(q, ki, vi, bitmap, k_scale=ks, v_scale=vs),
           lambda: decode_reference(q, ki, vi, bitmap, ks, vs, d**-0.5), None,
           4 * H * d * n_valid, 2 * b * H * d * 2 + n_valid * KVH * (d * 2 + 8) + b * S)
    records.pop("flash_decode[int8 cache]")  # the main path's cache is bf16; this line is the int8 check
    del kb, vb, ki, vi

    # K4: local compressor, key/value (32, 27, 27, 1152), one query per 4x3x3 tile
    t, h, w, c = 32, 27, 27, 1152
    key, val, qq = rn(t, h, w, c), rn(t, h, w, c), rn(t // 4, h // 3, w // 3, c)
    scale = torch.tensor(c**-0.5, device=dev)
    n_tiles = (t // 4) * (h // 3) * (w // 3)
    record("fused_tile_attention[local 32f]", "fused_tile_attention",
           lambda: fused_tile_attention(qq, key, val, (4, 3, 3), scale, 0.0),
           lambda: tile_reference(qq, key, val, (4, 3, 3), scale, 0.0), None,
           4 * n_tiles * 36 * c, 2 * t * h * w * c * 2 + 2 * n_tiles * c * 2)
    return records


def serving_config(layers: int = None):
    """The released HICom-7B serving configuration (bf16), optionally cut in depth."""
    import dataclasses

    from hicom_tpu_torch.config import HIComConfig, Qwen2Config, SiglipTextConfig, SiglipVisionConfig

    cfg = HIComConfig(text_config=Qwen2Config(), vision_config=SiglipVisionConfig(),
                      guide_text_config=SiglipTextConfig(), mm_vision_tower="google/siglip-so400m-patch14-384",
                      mm_projector_type="local43_global32", use_guide="direct", num_frames=32, dtype="bfloat16")
    if layers is not None:
        cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, num_hidden_layers=layers),
                          vision_config=dataclasses.replace(cfg.vision_config, num_hidden_layers=layers),
                          guide_text_config=dataclasses.replace(cfg.guide_text_config, num_hidden_layers=layers))
    return cfg


def make_requests(cfg, seed: int = 0):
    """Three requests: seeded prompt ids with one <video> sentinel, guide ids and
    a 32-frame 384x384 video each. Returns (batch of 2 right-padded, single)."""
    rng = np.random.default_rng(seed)
    L = 64

    def prompt(n):
        ids = rng.integers(0, cfg.text_config.vocab_size, (n,))
        ids[5] = -201  # <video>
        return ids

    size = cfg.vision_config.image_size
    video = lambda: rng.uniform(-1, 1, (cfg.num_frames, 3, size, size)).astype(np.float32)  # noqa: E731
    guide = lambda: rng.integers(0, cfg.guide_text_config.vocab_size, (cfg.guide_text_config.max_position_embeddings,))  # noqa: E731
    ids2 = np.zeros((2, L), np.int64)
    mask2 = np.zeros((2, L), bool)
    for i, n in enumerate((L, 41)):
        ids2[i, :n] = prompt(n)
        mask2[i, :n] = True
    batch = dict(input_ids=ids2, attention_mask=mask2, frames=np.stack([video(), video()]),
                 guide_ids=np.stack([guide(), guide()]))
    single = dict(input_ids=prompt(L)[None], frames=video()[None], guide_ids=guide()[None])
    return batch, single


@contextmanager
def plain_path():
    """Route attention to the plain paths while inside (kernels stay untouched)."""
    from hicom_tpu_torch.models import projector
    from hicom_tpu_torch.ops import attention
    from hicom_tpu_torch.ops.local_attn import tile_reference

    saved = attention.flash_route, projector.fused_tile_attention
    attention.flash_route = lambda *a, **k: None
    projector.fused_tile_attention = tile_reference
    try:
        yield
    finally:
        attention.flash_route, projector.fused_tile_attention = saved


def counters():
    from hicom_tpu_torch.ops.flash_attention import flash_forward, fullblock_attention
    from hicom_tpu_torch.ops.flash_decode import flash_decode
    from hicom_tpu_torch.ops.local_attn import fused_tile_attention

    return {f.__name__: f for f in (fullblock_attention, flash_forward, flash_decode, fused_tile_attention)}


def main_path(card: str):
    """Phase 4: the 7B slice answering 3 requests; returns launch counts."""
    import torch

    from hicom_tpu_torch.api import HICom, build_model

    cfg = serving_config()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[slice] built 7B model with seeded weights in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params")
    hc = HICom(config=cfg, model=model, eos_token_id=cfg.text_config.eos_token_id, cache_len=4096)
    batch, single = make_requests(cfg)
    hc.generate(**single, max_new_tokens=2)  # warm-up: cuBLAS handles, library loads
    torch.cuda.synchronize()

    fns = counters()
    for f in fns.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out2 = hc.generate(**batch, max_new_tokens=16)
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    out1 = hc.generate(**single, max_new_tokens=16)
    t_single = time.perf_counter() - t0
    launches = {name: f.launches for name, f in fns.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[slice] launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")

    vocab = cfg.text_config.vocab_size
    for out in (out2, out1):
        if not (np.all(np.isfinite(out)) and out.min() >= 0 and out.max() < vocab):
            raise AssertionError(f"generated ids out of range: {out}")
    log(f"[slice] batch of 2 ids: {out2.tolist()}")
    log(f"[slice] single ids: {out1.tolist()}")

    ttfts = []
    for _ in range(2):
        t0 = time.perf_counter()
        hc.generate(**single, max_new_tokens=1)
        ttfts.append(time.perf_counter() - t0)
    ttft = min(ttfts)
    decode_tps = stage_breakdown(hc, single)
    log(f"[slice] {card} | 3 requests (32 frames, 680 visual tokens, 16 new tokens): batch-of-2 request "
        f"{t_batch:.3f} s, single request {t_single:.3f} s | TTFT {ttft * 1e3:.1f} ms | decode "
        f"{decode_tps:.1f} tokens/s (single stream) | peak memory {peak_gb:.2f} GB")
    del model, hc
    torch.cuda.empty_cache()
    return launches


def stage_breakdown(hc, single, new_tokens: int = 16):
    """Phase 4a: the single request again, stage by stage (host clock around
    synchronised stages), then under torch.profiler: device kernel time by
    kernel and the device's idle share of the request's wall time. Returns the
    decode rate of one request, (new_tokens - 1) over the time from its first
    token to its last."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hicom_tpu_torch.models.generate import sample_and_loop
    from hicom_tpu_torch.models.qwen2 import KVCache

    model, cfg, dev = hc.model, hc.config, "cuda"
    tc = cfg.text_config

    @torch.inference_mode()
    def request(stamps):
        def mark(name):
            torch.cuda.synchronize()
            stamps.append((name, time.perf_counter()))

        mark("start")
        ids = torch.as_tensor(single["input_ids"], device=dev)
        frames = torch.as_tensor(single["frames"], device=dev, dtype=torch.bfloat16)
        ge = model.encode_guide(torch.as_tensor(single["guide_ids"], device=dev))
        mark("upload + guide encoder")
        b, t = frames.shape[:2]
        feats, embeds = model.model.vision_tower.vision_tower(frames.reshape((b * t,) + frames.shape[2:]))
        mark("vision tower")
        vis = model.model.mm_projector(feats.reshape((b, t) + feats.shape[1:]),
                                       embeds.reshape((b, t) + embeds.shape[1:]), ge, "video")
        mark("projector")
        sp = model.embed_and_splice(ids, vis)
        cache = KVCache.zeros(tc.num_hidden_layers, b, tc.num_key_value_heads, 4096, tc.head_dim,
                              torch.bfloat16, dev)
        hidden = model.model(sp.embeds, sp.positions, cache, prefill_from_empty=True)
        mark("splice + prefill")
        true_len = torch.full((b,), sp.embeds.shape[1], device=dev)
        # eos -1: no row stops, so every request takes new_tokens - 1 decode steps
        sample_and_loop(model, cache, hidden[:, -1:], true_len, new_tokens, 0.0, 0.9, -1, (),
                        on_token=lambda step: mark("first token") if step == 0 else None)
        mark(f"{new_tokens - 1} decode steps")

    stamps = []
    request(stamps)
    stamps = []
    request(stamps)
    parts = [f"{n} {1e3 * (t - stamps[i][1]):.1f} ms" for i, (n, t) in enumerate(stamps[1:])]
    log("[stages] " + " | ".join(parts))
    decode_tps = (new_tokens - 1) / (stamps[-1][1] - stamps[-2][1])

    stamps = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        request(stamps)
    wall_us = 1e6 * (stamps[-1][1] - stamps[0][1])
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy_us = sum(dev_time(e) for e in kernels)
    if busy_us <= 0:
        log("[profile] the profiler saw no device time")
        return decode_tps
    log(f"[profile] request wall {wall_us / 1e3:.1f} ms, device kernels {busy_us / 1e3:.1f} ms, "
        f"idle share {1 - busy_us / wall_us:.3f}")
    for e in sorted(kernels, key=dev_time, reverse=True)[:10]:
        log(f"[profile]   {dev_time(e) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    return decode_tps


def plain_vs_kernel_logits():
    """Phase 4b: at 2 decoder and 2 tower layers, the kernel path's last-token
    prefill logits against the plain path's, on the batch-of-2 request."""
    import torch

    from hicom_tpu_torch.api import build_model

    cfg = serving_config(layers=2)
    model = build_model(cfg, device="cuda", seed=2)
    batch, _ = make_requests(cfg, seed=3)
    dev, dt = "cuda", torch.bfloat16

    @torch.inference_mode()
    def last_logits():
        ids = torch.as_tensor(batch["input_ids"], device=dev)
        mask = torch.as_tensor(batch["attention_mask"], device=dev)
        ge = model.encode_guide(torch.as_tensor(batch["guide_ids"], device=dev))
        vis = model.encode_visual(torch.as_tensor(batch["frames"], device=dev, dtype=dt), ge, "video")
        sp = model.embed_and_splice(ids, vis, mask)
        hidden = model.model(sp.embeds, sp.positions, padding_mask=sp.attention_mask)
        last = sp.attention_mask.sum(dim=1) - 1
        return model.logits(hidden[torch.arange(2, device=dev), last]).float()

    got = last_logits()
    with plain_path():
        ref = last_logits()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    # bf16 activations round at other points on the two paths (flash tiles vs
    # whole-row softmax) through 2 tower, 2 guide and 2 decoder layers: hold the
    # difference to 5% of the logits' largest magnitude
    tol = 0.05 * scale
    log(f"[slice] 2-layer last-token logits, kernel vs plain path: max_abs_err {err:.3g} (tol {tol:.3g}, "
        f"max |logit| {scale:.3g}), finite {bool(torch.isfinite(got).all())}")
    if not (torch.isfinite(got).all() and scale > 0 and err <= tol):
        raise AssertionError("kernel-path logits disagree with the plain path")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from hicom_tpu_torch.ops import cuda_build
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository (hicom_tpu_torch not found)", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    log(f"[device] {card} | {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda} | python {sys.version.split()[0]}")
    # full fp32 products in the plain references (cuDNN convolutions default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    seconds = cuda_build.build_all()
    log(f"[build] {len(seconds)} kernels in {time.perf_counter() - t0:.1f} s "
        + " ".join(f"{k}={v:.1f}s" for k, v in seconds.items()))

    records = kernel_checks(card)
    launches = main_path(card)
    plain_vs_kernel_logits()

    kernels = []
    for name, (wrapper, rec) in records.items():
        rec["launches"] = launches[wrapper]
        kernels.append(rec)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
