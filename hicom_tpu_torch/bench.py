"""Benchmark of the port on one NVIDIA GPU: end-to-end video compression and
prefill throughput, decode steps, train steps and ingest from disk.

The port of the repository's ``bench.py``, with its workloads, flags, metric
names and JSON line, measured through the port's entry points and its
hand-written kernels. The headline pipeline: a 32-frame video through the
SigLIP-so400m tower, the HICom ``local43_global32`` compressor (direct
guide), the decoder prefill over [visual; text] tokens and the first-token
logits, reported as ``video_frames_per_sec_per_chip_e2e_prefill``. The
default batch is 4 videos a step; ``--batch 1`` is the reference's serving
shape. The default numerics are a calibrated ``w8a8s_mlp_qkv`` tower and a
``w8a8`` decoder; a second arm then times bf16 numerics (an int8
weight-only decoder at 7B, as ``serving_config`` defines it) in the same run.
``--modal image`` benches the single-image pipeline, ``--frames 64`` the long
video, ``--decode`` / ``--train`` / ``--from-disk`` the decode step, the train
step and the ingest-inclusive pipeline.

``vs_baseline`` compares with an analytic A100 for the same computation: its
bf16 peak, 312 TFLOP/s, at 45% MFU. Utilization is against the card's
data-sheet peaks (:data:`PEAKS`), int8 sites at the int8 peak and bf16 sites
at the bf16 peak. Times are the median of timed groups: each group queues
``--sync-every`` calls and ends with one read of the accumulated result, on
the host clock around it. The JSON line also carries the card (name, power
limit, SM clock, power draw and temperature before and after each arm's
timed groups), the peak device memory and the kernels' launch counts over
the timed groups.

Run on the card, or with ``--small --device cpu`` as a sanity run of each
mode at a tiny size on the CPU, whose JSON carries no time (``null``)::

    python3 -m hicom_tpu_torch.bench                   # so400m + Qwen2.5-1.5B widths, full depth
    python3 -m hicom_tpu_torch.bench --decode --kv-int8
    python3 -m hicom_tpu_torch.bench --small --device cpu

Weights are drawn from a seed on the card (``api.build_model``): no download.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import gc
import json
import os
import platform
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import HIComConfig, Qwen2Config, SiglipTextConfig, SiglipVisionConfig, tiny_test_config
from .constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX, VIDEO_TOKEN_INDEX
from .models.quant import parse_tower_quant, quant_covers


class Peaks(NamedTuple):
    """A card's dense data-sheet peaks: bf16 FLOP/s, int8 OP/s, memory bytes/s."""

    bf16: float
    int8: float
    hbm: float


# NVIDIA's H100 data sheets, by a part of the card's name (SXM when none matches)
PEAKS = {"PCIe": Peaks(756e12, 1513e12, 2.0e12), "NVL": Peaks(835e12, 1671e12, 3.9e12),
         "": Peaks(989e12, 1979e12, 3.35e12)}
# the baseline: an analytic A100 at its bf16 peak and 45% MFU
A100_FLOPS, A100_MFU = 312e12, 0.45
# detail fields read off a clock or the card: null in a run on the CPU
DEVICE_FIELDS = (
    "ttft_ms_per_video", "achieved_tflops", "mfu_pct", "vs_baseline_cap", "pct_of_cap", "best_frames_per_sec",
    "mean_frames_per_sec", "group_ms", "bf16_frames_per_sec", "vs_baseline_bf16", "vs_baseline_bf16_cap",
    "bf16_pct_of_cap", "bf16_mfu_pct", "bf16_group_ms", "quant_speedup_vs_bf16", "step_ms",
    "pipelined_from_disk_fps", "ingest_only_fps", "chip_only_fps", "analytic_production_host_fps",
    "upload_plus_one_ingest_ms", "peak_gb", "bf16_peak_gb")
DECODE_ROW_TIMES = ("ms_per_step", "tok_per_s")


def card_peaks(name: str) -> Peaks:
    return next(p for part, p in PEAKS.items() if part in name)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------- #
# Configurations and the FLOP and byte models
# --------------------------------------------------------------------------- #


def serving_config(model: str = "1.5b", frames: int = 32, tower_quant: Optional[str] = None,
                   layers: Optional[int] = None, **overrides) -> HIComConfig:
    """The benchmark's serving configurations.

    "1.5b": so400m + the widths of Qwen2.5-1.5B (untied embeddings).
    "7b":   so400m + the widths of Qwen2.5-7B, int8 weight-only decoder.
    ``tower_quant``: None or a tower mode of ``models/quant.py``;
    ``layers``: the tower's and the decoder's depth when cut (a check of the
    mode at its widths, not a measurement of the configuration);
    ``overrides`` update the text config (e.g. kv_cache_int8=True).
    """
    if model == "7b":
        text = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
                    num_attention_heads=28, num_key_value_heads=4, head_dim=128, rope_theta=1000000.0,
                    quantization="int8")
    else:
        text = dict(vocab_size=151936, hidden_size=1536, intermediate_size=8960, num_hidden_layers=28,
                    num_attention_heads=12, num_key_value_heads=2, head_dim=128, rope_theta=1000000.0)
    text.update(overrides)
    depth = {} if layers is None else dict(num_hidden_layers=layers)
    return HIComConfig(
        text_config=Qwen2Config(**dict(text, **depth)),
        vision_config=SiglipVisionConfig(quantization=tower_quant, **depth),
        guide_text_config=SiglipTextConfig(),
        mm_vision_tower="google/siglip-so400m-patch14-384",
        mm_projector_type="local43_global32",
        use_guide="direct",
        num_frames=frames,
        dtype="bfloat16",
    )


def flops_components(cfg, b: int, t: int, L: int, small: bool):
    """FLOPs of the measured pipeline by site (tower qkv/out/mlp/attention,
    decoder linears/attention), so that a quantized arm's MFU takes each
    site at the peak of its numerics. The compressor and the guide encoder
    (under 2%) are not counted. Returns (components, spliced length S)."""
    v, tc = cfg.vision_config, cfg.text_config
    n = v.num_patches
    vis_tok = n * (b * t)
    per = 2 * v.num_hidden_layers * vis_tok
    comp = {
        "vis_qkv": per * 3 * v.hidden_size ** 2,
        "vis_out": per * v.hidden_size ** 2,
        "vis_mlp": per * 2 * v.hidden_size * v.intermediate_size,
        # tower attention: qk^T + pV = 4·n²·d per layer-frame
        "vis_attn": v.num_hidden_layers * (b * t) * 4 * n ** 2 * v.hidden_size,
    }
    # visual tokens after compression: local43 = ceil(t/4)·9·9 (an image has
    # t = 1) + 32 global: 113 at t = 1, 680 at t = 32, 1328 at t = 64
    Vtok = 36 if small else (-(-t // 4) * 81 + 32)
    S = L - 1 + Vtok
    comp["dec_qkvo"] = 2 * tc.num_hidden_layers * (
        tc.hidden_size * tc.head_dim * (tc.num_attention_heads + 2 * tc.num_key_value_heads)
        + tc.num_attention_heads * tc.head_dim * tc.hidden_size) * S * b
    comp["dec_mlp"] = 2 * tc.num_hidden_layers * 3 * tc.hidden_size * tc.intermediate_size * S * b
    # decoder causal attention ≈ 2·S²·(H·dh) (qk + pv at half the S² each)
    comp["dec_attn"] = tc.num_hidden_layers * b * 2 * S ** 2 * tc.num_attention_heads * tc.head_dim
    return comp, S


def int8_executed_flops(comp: dict, tower_quant: str, dec_quant: str) -> int:
    """FLOPs that run as int8 products under the given modes. Weight-only
    'int8'/'nf4' decoders dequantize to bf16 products: not counted."""
    base, _, _ = parse_tower_quant(None if tower_quant in (None, "none") else tower_quant)
    int8 = 0
    if base:
        for site, key in (("mlp", "vis_mlp"), ("qkv", "vis_qkv"), ("out", "vis_out")):
            if quant_covers(base, site):
                int8 += comp[key]
    if dec_quant in ("w8a8", "w8a8s"):
        int8 += comp["dec_qkvo"] + comp["dec_mlp"]
    elif dec_quant in ("w8a8_mlp", "w8a8s_mlp"):
        int8 += comp["dec_mlp"]
    return int8


def matched_mfu_pct(total_flops: int, int8_flops: int, dt: float, peaks: Peaks) -> float:
    """Utilization against the numerics-matched roofline: the least time is
    the int8 work at the int8 peak plus the rest at the bf16 peak, so it
    cannot exceed 100."""
    ideal = int8_flops / peaks.int8 + (total_flops - int8_flops) / peaks.bf16
    return 100.0 * ideal / dt


def vs_baseline_cap(comp: dict, int8_flops: int, peaks: Peaks) -> float:
    """The largest ``vs_baseline`` one arm could reach: the analytic A100's
    time over the card's least time, int8 sites at the int8 peak and every
    other site (the tower's attention too) at the bf16 peak."""
    tot = sum(comp.values())
    vis_attn = comp.get("vis_attn", 0)
    ideal = int8_flops / peaks.int8 + vis_attn / peaks.bf16 + (tot - int8_flops - vis_attn) / peaks.bf16
    return (tot / (A100_FLOPS * A100_MFU)) / ideal


def train_flops(cfg, b: int, t: int, L: int, parts: str, small: bool):
    """FLOPs of one train step by freeze matrix (remat's recompute not
    counted), and the spliced length S. The tower is the graph's root: frozen, one forward. The decoder
    and head sit downstream of the trained projector, so even frozen they pay
    the activation backward (2x), and 3x when they train. QLoRA: tower 1x,
    decoder and head 2x (the adapters' weight gradient is negligible)."""
    vis_mult = 3 if "pure_vision_model" in parts else 1
    lm_mult = 3 if "language_model" in parts else 2
    v, tc = cfg.vision_config, cfg.text_config
    tokens = v.num_patches
    vis_params = v.num_hidden_layers * (4 * v.hidden_size ** 2 + 2 * v.hidden_size * v.intermediate_size)
    vis = 2 * vis_params * tokens * (b * t) + v.num_hidden_layers * (b * t) * 4 * tokens ** 2 * v.hidden_size
    Vtok = 680 if not small else 36
    S = L - 1 + Vtok
    dec_params = tc.num_hidden_layers * (
        tc.hidden_size * tc.head_dim * (tc.num_attention_heads + 2 * tc.num_key_value_heads)
        + tc.num_attention_heads * tc.head_dim * tc.hidden_size
        + 3 * tc.hidden_size * tc.intermediate_size)
    dec = 2 * dec_params * S * b + tc.num_hidden_layers * b * 2 * S ** 2 * tc.num_attention_heads * tc.head_dim
    head = 2 * tc.vocab_size * tc.hidden_size * S * b
    return vis_mult * vis + lm_mult * (dec + head), S


def decode_weight_bytes(tc) -> int:
    """Bytes one decode step must read: the decoder's linears (1 byte a
    weight int8, else 2) and the bf16 head."""
    wbytes = 1 if tc.quantization == "int8" else 2
    return tc.num_hidden_layers * (
        tc.hidden_size * tc.head_dim * (tc.num_attention_heads + 2 * tc.num_key_value_heads)
        + tc.num_attention_heads * tc.head_dim * tc.hidden_size
        + 3 * tc.hidden_size * tc.intermediate_size
    ) * wbytes + tc.vocab_size * tc.hidden_size * 2


# --------------------------------------------------------------------------- #
# The card, the counters, the clock
# --------------------------------------------------------------------------- #


def _number(s: str):
    try:
        return float(s.split()[0])
    except (ValueError, IndexError):
        return None


def card_stamp() -> dict:
    """The card's name, power limit (W), SM clock (MHz), power draw (W) and
    temperature (C), as ``nvidia-smi`` reads them now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    name, limit, sm, draw, temp = (s.strip() for s in out.stdout.strip().splitlines()[0].split(","))
    return {"name": name, "power_limit_w": _number(limit), "sm_clock_mhz": _number(sm),
            "power_draw_w": _number(draw), "temperature_c": _number(temp)}


def device_detail(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": platform.processor() or platform.machine(), "count": 1,
                "power_limit_w": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": torch.cuda.device_count(),
            "power_limit_w": card_stamp()["power_limit_w"]}


def stamp(device: torch.device) -> Optional[dict]:
    return card_stamp() if device.type == "cuda" else None


def stamps(device: torch.device, before: Optional[dict]) -> Optional[dict]:
    """The card before a timed window (``before``) and now, after it."""
    return {"before": before, "after": card_stamp()} if device.type == "cuda" else None


def kernel_counters() -> dict:
    """The kernel wrappers by name; each counts the launches it makes."""
    from .ops.flash_attention import flash_backward, flash_forward, fullblock_attention
    from .ops.flash_decode import flash_decode
    from .ops.local_attn import fused_tile_attention

    fns = (fullblock_attention, flash_forward, flash_decode, fused_tile_attention, flash_backward)
    return {f.__name__: f for f in fns}


def reset_launches() -> None:
    for f in kernel_counters().values():
        f.launches = 0


def read_launches() -> dict:
    return {name: f.launches for name, f in kernel_counters().items()}


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_gb(device: torch.device) -> Optional[float]:
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def median(xs):
    return sorted(xs)[len(xs) // 2]


def emit(result: dict, device: torch.device) -> None:
    """Print the JSON line; a CPU run's time-derived numbers become null."""
    if device.type != "cuda":
        result["value"] = result["vs_baseline"] = None
        detail = result["detail"]
        for key in DEVICE_FIELDS:
            if key in detail:
                detail[key] = None
        for row in detail.get("table", ()):
            row.update(dict.fromkeys(DECODE_ROW_TIMES))
    print(json.dumps(result), flush=True)


def _budget_left(args, default: float = 1200.0) -> float:
    """Seconds left of the run's budget (env HICOM_BENCH_BUDGET, default 20
    min): the bf16 arm is skipped when it is spent; the headline line is
    printed by then."""
    budget = float(os.environ.get("HICOM_BENCH_BUDGET", str(default)))
    return budget - (time.monotonic() - args._t0)


# --------------------------------------------------------------------------- #
# The prefill pipeline
# --------------------------------------------------------------------------- #


@torch.inference_mode()
def prefill_scalar(model, input_ids, frames, guide_ids, modal: str) -> torch.Tensor:
    """guide encoder -> tower and projector -> splice -> decoder prefill ->
    the last token's logits, summed to one fp32 scalar on the device. The
    prompts are unpadded, so the prefill is the mask-free causal one."""
    ge = model.encode_guide(guide_ids)
    visual = model.encode_visual(frames, ge, modal)
    sp = model.embed_and_splice(input_ids, visual)
    hidden = model.model(sp.embeds, sp.positions)
    return model.logits(hidden[:, -1:]).float().sum()


def arm_inputs(cfg, b: int, t: int, sentinel: int, L: int = 48):
    """Prompt ids with the sentinel at position 2, frames and 24 guide ids
    per row, from ``np.random.default_rng(0)`` (numpy; frames fp32)."""
    rng = np.random.default_rng(0)
    img = cfg.vision_config.image_size
    ids = rng.integers(5, cfg.text_config.vocab_size, (b, L))
    ids[:, 2] = sentinel
    frames = rng.standard_normal((b, t, 3, img, img)).astype(np.float32)
    gids = rng.integers(1, cfg.guide_text_config.vocab_size, (b, 24))
    return ids, frames, gids


@dataclasses.dataclass
class Arm:
    """One numerics arm: a seeded model on the device and its inputs."""

    cfg: HIComConfig
    model: torch.nn.Module
    input_ids: torch.Tensor
    frames: torch.Tensor
    guide_ids: torch.Tensor
    modal: str

    @property
    def b(self) -> int:
        return self.input_ids.shape[0]

    @property
    def t(self) -> int:
        return self.frames.shape[1]

    def __call__(self, frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        return prefill_scalar(self.model, self.input_ids, self.frames if frames is None else frames,
                              self.guide_ids, self.modal)


def _make_arm(args, tower_quant: str, dec_quant: str, device: torch.device) -> Arm:
    """Build one arm: the configuration (7B keeps its int8 weight-only
    decoder for ``--dec-quant none``), ``build_model``'s seeded weights, a
    static tower and decoder calibrated on the first row's first 8 frames."""
    from .api import HICom, build_model

    modal = args.modal
    if args.small:
        cfg = tiny_test_config(use_guide="direct", dtype="bfloat16")
        t = 4
    else:
        tq = None if tower_quant == "none" else tower_quant
        dq = {} if dec_quant == "none" else {"quantization": dec_quant}
        cfg = serving_config(args.model, frames=args.frames, tower_quant=tq, layers=args.layers, **dq)
        t = 1 if modal == "image" else args.frames
    sentinel = IMAGE_TOKEN_INDEX if modal == "image" else VIDEO_TOKEN_INDEX
    ids, frames, gids = arm_inputs(cfg, args.batch, t, sentinel)
    model = build_model(cfg, device=device, seed=0)
    dtype = model.model.norm.weight.dtype
    arm = Arm(cfg, model, torch.from_numpy(ids).to(device), torch.from_numpy(frames).to(device, dtype),
              torch.from_numpy(gids).to(device), modal)
    hc = HICom(config=cfg, model=model)
    calib_frames = arm.frames[:1, : min(8, t)]
    if not args.small and tower_quant.startswith("w8a8s"):
        hc.calibrate_tower(calib_frames, arm.guide_ids[:1], modal=modal)
    if not args.small and dec_quant.startswith("w8a8s"):
        hc.calibrate_decoder(arm.input_ids[:1], calib_frames, arm.guide_ids[:1], modal=modal)
    return arm


def _warm_arm(fn, sync_every: int) -> None:
    """One untimed call and one untimed group (first-use allocations, cuBLAS
    handles, the kernels' first launches)."""
    fn().item()
    acc = fn()
    for _ in range(sync_every - 1):
        acc = acc + fn()
    acc.item()


def _time_groups(fn, iters: int, sync_every: int) -> list:
    """Seconds per call of each timed group: ``sync_every`` calls queued, the
    accumulated scalar read once at the end, on the host clock."""
    group_dts = []
    for i in range(0, iters, sync_every):
        n = min(sync_every, iters - i)
        g0 = time.perf_counter()
        acc = fn()
        for _ in range(n - 1):
            acc = acc + fn()
        acc.item()
        group_dts.append((time.perf_counter() - g0) / n)
    return group_dts


def _config_name(args) -> str:
    if args.small:
        return "tiny"
    return (("so400m+qwen2.5-7B-int8" if args.model == "7b" else "so400m+qwen2.5-1.5B")
            + (f"-tower:{args.tower_quant}" if args.tower_quant != "none" else "")
            + (f"-dec:{args.dec_quant}" if args.dec_quant != "none" else "")
            + ("-image" if args.modal == "image" else "") + _depth_tag(args))


def _depth_tag(args) -> str:
    return f"-{args.layers}layers" if args.layers is not None else ""


def _run(args, device: torch.device) -> None:
    """The headline arm, its JSON line printed at once, then the bf16 arm
    (budget permitting) and the line again with both."""
    fp_dec = "int8" if args.model == "7b" else "none"
    dual = (not args.small and not args.no_bf16_arm
            and (args.tower_quant, args.dec_quant) != ("none", fp_dec))
    dev = device_detail(device)
    peaks = card_peaks(dev["kind"])

    def run_arm(name, tq, dq, iters):
        log(f"arm[{name}]: build ({tq}/{dq})")
        reset_peak(device)
        arm = _make_arm(args, tq, dq, device)
        log(f"arm[{name}]: warm")
        _warm_arm(arm, args.sync_every)
        before = stamp(device)
        reset_launches()
        gdts = _time_groups(arm, iters, args.sync_every)
        launches = read_launches()
        card = stamps(device, before)
        peak = peak_gb(device)
        if device.type == "cuda":
            log(f"arm[{name}]: groups {[round(g * 1e3, 1) for g in gdts]} ms, launches {launches}")
        shape = arm.cfg, arm.b, arm.t
        del arm
        free(device)
        return (gdts, launches, card, peak) + shape

    group_dts, launches, card, peak, cfg, b, t = run_arm("headline", args.tower_quant, args.dec_quant, args.iters)
    L = 48  # prompt ids per video (arm_inputs)
    mean_dt = sum(group_dts) / len(group_dts)
    dt = median(group_dts)
    frames_per_sec = b * t / dt
    comp, _ = flops_components(cfg, b, t, L, args.small)
    flops = sum(comp.values())
    int8_flops = int8_executed_flops(comp, args.tower_quant, args.dec_quant)
    a100_frames_per_sec = b * t / (flops / (A100_FLOPS * A100_MFU))
    vs_baseline = frames_per_sec / a100_frames_per_sec
    cap = vs_baseline_cap(comp, int8_flops, peaks)
    bf16_detail = {}
    if (args.tower_quant, args.dec_quant) == ("none", fp_dec):  # the headline is the bf16 arm
        bf16_detail = {"vs_baseline_bf16": round(vs_baseline, 3)}
    result = {
        "metric": ("image_samples_per_sec_per_chip_e2e_prefill" if args.modal == "image"
                   else "video_frames_per_sec_per_chip_e2e_prefill"),
        "value": round(frames_per_sec, 2),
        "unit": "images/s" if args.modal == "image" else "frames/s",
        "vs_baseline": round(vs_baseline, 3),
        "detail": {
            "ttft_ms_per_video": round(dt / b * 1e3, 2),
            "batch_videos": b,
            "frames_per_video": t,
            "flops": flops,
            "achieved_tflops": round(flops / dt / 1e12, 1),
            "mfu_pct": round(matched_mfu_pct(flops, int8_flops, dt, peaks), 1),
            "int8_flop_frac": round(int8_flops / flops, 3),
            "vs_baseline_cap": round(cap, 3),
            "pct_of_cap": round(100 * vs_baseline / cap, 1),
            "best_frames_per_sec": round(b * t / min(group_dts), 2),
            "mean_frames_per_sec": round(b * t / mean_dt, 2),
            "group_ms": [round(g * 1e3, 1) for g in group_dts],
            **bf16_detail,
            "config": _config_name(args),
            "baseline_model": "analytic A100 bf16 roofline @45% MFU, same computation "
                              "(derivation: BASELINE.md §baseline-derivation)",
            "device": dev,
            "peak_gb": peak,
            "kernel_launches": launches,
            "card_stamp": card,
        },
    }
    emit(result, device)
    if not dual:
        return
    left = _budget_left(args)
    if left < 120:
        log(f"bf16 arm skipped: budget spent ({left:.0f} s left; set HICOM_BENCH_BUDGET to raise it)")
        return
    bdts, blaunches, bcard, bpeak, *_ = run_arm("bf16", "none", fp_dec, args.iters_bf16)
    bdt = median(bdts)
    bf16_fps = b * t / bdt
    bf16_cap = vs_baseline_cap(comp, 0, peaks)
    result["detail"].update({
        "bf16_frames_per_sec": round(bf16_fps, 2),
        "vs_baseline_bf16": round(bf16_fps / a100_frames_per_sec, 3),
        "vs_baseline_bf16_cap": round(bf16_cap, 3),
        "bf16_pct_of_cap": round(100 * (bf16_fps / a100_frames_per_sec) / bf16_cap, 1),
        "bf16_mfu_pct": round(matched_mfu_pct(flops, 0, bdt, peaks), 1),
        "bf16_group_ms": [round(g * 1e3, 1) for g in bdts],
        "bf16_peak_gb": bpeak,
        "bf16_kernel_launches": blaunches,
        "bf16_card_stamp": bcard,
        "quant_speedup_vs_bf16": round(frames_per_sec / bf16_fps, 3),
    })
    emit(result, device)


# --------------------------------------------------------------------------- #
# Decode steps
# --------------------------------------------------------------------------- #


def decode_cache(tc, b: int, cache_len: int, device, dtype=torch.bfloat16):
    """A zero KV cache of ``cache_len`` slots (``dtype``, or int8 with
    ``tc.kv_cache_int8``) whose first ``cache_len - 64`` slots are marked
    written, the write offset after them."""
    from .models.qwen2 import KVCache

    valid = cache_len - 64
    cache = KVCache.zeros(tc.num_hidden_layers, b, tc.num_key_value_heads, cache_len, tc.head_dim, dtype, device,
                          quantized=tc.kv_cache_int8)
    cache.valid[:, :valid] = True
    cache.length = valid
    return cache


@torch.inference_mode()
def decode_step(model, emb, cache, pos) -> torch.Tensor:
    """One decoder step of (b, 1, hidden) embeddings over ``cache`` (written
    in place) -> (b, 1, vocab) logits."""
    return model.logits(model.model(emb, pos, cache))


def _run_decode(args, device: torch.device) -> None:
    """Decode steps at b ∈ {1, 4, 8}: one weight read shared by b rows.
    ``vs_baseline``: b = 1 tokens/s over the weight-reading floor (the step's
    weight bytes over the card's memory rate)."""
    from .api import build_model
    from .profiling import device_time

    cache_len = 1024
    if args.small:
        cfg = tiny_test_config(use_guide="direct", dtype="bfloat16")
        cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, kv_cache_int8=args.kv_int8))
        cache_len = 128
    else:
        cfg = serving_config(args.model, frames=args.frames, layers=args.layers, kv_cache_int8=args.kv_int8)
    dev = device_detail(device)
    peaks = card_peaks(dev["kind"])
    reset_peak(device)
    model = build_model(cfg, device=device, seed=0)
    dtype = model.model.norm.weight.dtype
    tc = cfg.text_config
    rng = np.random.default_rng(0)

    def feedback(logits, a):
        emb2 = (logits[..., :tc.hidden_size] * 1e-3).to(dtype)
        return (a[0], emb2, a[2], a[3] + 1)

    rows = []
    before = stamp(device)
    reset_launches()
    for b in (1, 4, 8):
        cache = decode_cache(tc, b, cache_len, device, dtype)
        emb = torch.from_numpy(rng.standard_normal((b, 1, tc.hidden_size))).to(device, dtype)
        pos = torch.full((b, 1), cache_len - 64, dtype=torch.int64, device=device)
        t = device_time(decode_step, model, emb, cache, pos, iters=2, chain=8, feedback=feedback)
        rows.append({"batch": b, "ms_per_step": round(t * 1e3, 3), "tok_per_s": round(b / t, 1)})
        if device.type == "cuda":
            log(f"decode b={b}: {rows[-1]}")
        del cache
    launches = read_launches()
    card = stamps(device, before)
    floor_tok_s = peaks.hbm / decode_weight_bytes(tc)
    result = {
        "metric": "decode_tok_per_s",
        "value": rows[0]["tok_per_s"],
        "unit": "tok/s@b1",
        "vs_baseline": round(rows[0]["tok_per_s"] / floor_tok_s, 3),
        "detail": {
            "table": rows, "cache_len": cache_len, "kv_int8": bool(args.kv_int8),
            "weight_bytes": decode_weight_bytes(tc),
            "config": ("tiny" if args.small else ("so400m+qwen2.5-7B-int8" if args.model == "7b"
                                                   else "so400m+qwen2.5-1.5B") + _depth_tag(args)),
            "baseline_model": f"weight-reading floor (decoder bytes / {peaks.hbm / 1e12:g} TB/s, the card's "
                              "data-sheet memory rate)",
            "device": dev,
            "peak_gb": peak_gb(device),
            "kernel_launches": launches,
            "card_stamp": card,
        },
    }
    emit(result, device)


# --------------------------------------------------------------------------- #
# Train steps
# --------------------------------------------------------------------------- #


def _run_train(args, device: torch.device) -> None:
    """Train-step throughput on one card: tower, projector and decoder with
    remat and the flash forward and backward kernels, no accumulation.
    ``--train-parts mm_projector`` (default) is the reference's stage-1
    projector pretrain: tower and decoder frozen, the decoder's activation
    backward carrying the gradient to the projector. ``--bits 4/8``: QLoRA,
    LoRA adapters over an NF4 / int8 decoder (``train/lora.py``; the
    AdamW of ``create_lora_state``, as the CLI's ``--bits``). ``vs_baseline``:
    the analytic A100's time for the step over the measured step."""
    from .api import build_model
    from .train.optimizer import build_optimizer
    from .train.train_step import batch_to_device, create_train_state, make_train_step

    parts = args.train_parts
    over = {"quantization": "nf4" if args.bits == 4 else "int8"} if args.bits != 16 else {}
    if args.small:  # a sanity run of the mode, not a measurement
        cfg = tiny_test_config(use_guide="direct", dtype="float32")
        cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, remat=True, **over))
        b, t, L = 2, 4, 16
    else:
        cfg = serving_config(args.model, frames=args.frames, layers=args.layers, remat=True, **over)
        b, t, L = args.batch, args.frames, 48
    dev = device_detail(device)
    peaks = card_peaks(dev["kind"])
    rng = np.random.default_rng(0)
    img = cfg.vision_config.image_size
    requested_b = b
    reset_peak(device)
    model = build_model(cfg, device=device, seed=0)
    dtype = model.model.norm.weight.dtype

    def make_batch(b):
        ids = rng.integers(5, cfg.text_config.vocab_size, (b, L))
        ids[:, 2] = VIDEO_TOKEN_INDEX
        labels = np.array(ids)
        labels[:, :8] = IGNORE_INDEX
        batch = {"input_ids": ids, "frames": rng.standard_normal((b, t, 3, img, img)).astype(np.float32),
                 "labels": labels, "guide_ids": rng.integers(1, cfg.guide_text_config.vocab_size, (b, 24))}
        return batch_to_device(batch, device, dtype)

    if args.bits != 16:
        from .train.lora import init_lora_params
        from .train.train_step import create_lora_state, make_lora_train_step

        qmode = cfg.text_config.quantization
        lora = init_lora_params(model, rank=args.lora_r, generator=torch.Generator(device).manual_seed(0))
        # optax.adamw(1e-4)'s update: constant rate, weight decay 1e-4; alpha 16
        state = create_lora_state(model, lora, alpha=16.0, rank=args.lora_r, learning_rate=1e-4,
                                  total_steps=1000, warmup_ratio=0.0, schedule_kind="constant",
                                  weight_decay=1e-4, device=device)
        del lora
        parts = f"qlora_{qmode}_r{args.lora_r}"
        step = make_lora_train_step()
    else:
        optimizer = build_optimizer(model, learning_rate=1e-5, total_steps=1000, tunable_parts=parts,
                                    use_guide=cfg.use_guide, schedule_kind="constant")
        state = create_train_state(model, optimizer, device=device)
        step = make_train_step()

    batch = make_batch(b)
    while True:  # the first step, halving the batch while it does not fit
        try:
            state, metrics = step(state, batch)
            metrics["loss"].item()
            break
        except torch.cuda.OutOfMemoryError as e:
            if b <= 1:
                raise
            log(f"out of memory at batch {b}; retrying batch {b // 2} ({str(e)[:160]})")
            b //= 2
            del batch
            free(device)
            batch = make_batch(b)
    for _ in range(args.sync_every):  # one untimed group
        state, metrics = step(state, batch)
    metrics["loss"].item()

    before = stamp(device)
    reset_launches()
    group_dts = []
    for i in range(0, args.iters, args.sync_every):
        n = min(args.sync_every, args.iters - i)
        g0 = time.perf_counter()
        for _ in range(n):
            state, metrics = step(state, batch)
        metrics["loss"].item()
        group_dts.append((time.perf_counter() - g0) / n)
    launches = read_launches()
    card = stamps(device, before)
    dt = median(group_dts)
    flops, S = train_flops(cfg, b, t, L, parts, args.small)
    achieved_tflops = flops / dt / 1e12
    result = {
        "metric": "train_step_target_tokens_per_sec_per_chip",
        "value": round(b * S / dt, 1),
        "unit": "tok/s",
        "vs_baseline": round(flops / (A100_FLOPS * A100_MFU) / dt, 3),
        "detail": {
            "step_ms": round(dt * 1e3, 1),
            "batch_videos": b, "frames_per_video": t, "spliced_len": S,
            "flops": flops,
            "achieved_tflops": round(achieved_tflops, 1),
            "mfu_pct": round(100 * achieved_tflops * 1e12 / peaks.bf16, 1),
            "group_ms": [round(g * 1e3, 1) for g in group_dts],
            "loss": float(metrics["loss"]),
            "tunable_parts": parts, "remat": True,
            **({"auto_shrunk_from_batch": requested_b} if b != requested_b else {}),
            "config": ("tiny" if args.small else
                       f"so400m+qwen2.5-{args.model}" + (f"-qlora{args.bits}bit" if args.bits != 16 else "")
                       + _depth_tag(args)),
            "baseline_model": "analytic A100 bf16 roofline @45% MFU, same step "
                              "(BASELINE.md §baseline-derivation)",
            "device": dev,
            "peak_gb": peak_gb(device),
            "kernel_launches": launches,
            "card_stamp": card,
        },
    }
    emit(result, device)


# --------------------------------------------------------------------------- #
# End to end from files on disk
# --------------------------------------------------------------------------- #


def write_realistic_mp4(path: str, seconds: float = 10.0, size=(640, 360), fps: float = 25.0,
                        seed: int = 0) -> None:
    """A synthetic clip that codecs treat like a real one: smooth moving
    gradients and a moving block of noise (pure noise would decode too
    slowly, static frames too fast)."""
    import cv2

    w, h = size
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        raise OSError(f"cv2 cannot write {path}")
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phases = rng.uniform(0, 6.28, 3)
    for i in range(int(seconds * fps)):
        t = i / fps
        frame = np.stack([
            127 + 120 * np.sin(xx / 40 + 2 * t + phases[0]),
            127 + 120 * np.sin(yy / 30 - 1.5 * t + phases[1]),
            127 + 120 * np.sin((xx + yy) / 60 + t + phases[2]),
        ], axis=-1)
        bx, by = int((t * 80) % (w - 60)), int((t * 50) % (h - 60))
        frame[by:by + 60, bx:bx + 60] = rng.integers(0, 255, (60, 60, 3))
        vw.write(frame.astype(np.uint8))
    vw.release()


class Uploader:
    """Host batches onto the device from a worker thread: through pinned
    memory, copied on a stream of its own, the copy finished before the
    worker returns; :meth:`take` makes the compute stream wait on it."""

    def __init__(self, device: torch.device, dtype: Optional[torch.dtype]):
        self.device, self.dtype = device, dtype
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(self, x: np.ndarray):
        host = torch.from_numpy(x)
        dtype = self.dtype or host.dtype
        if self.stream is None:
            return host.to(self.device, dtype), None
        pinned = host.pin_memory()
        with torch.cuda.stream(self.stream):
            dev = pinned.to(self.device, non_blocking=True).to(dtype)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()  # the pinned buffer may go once this returns
        return dev, done

    @staticmethod
    def take(item) -> torch.Tensor:
        dev, done = item
        if done is not None:
            current = torch.cuda.current_stream(dev.device)
            current.wait_event(done)
            dev.record_stream(current)  # allocated on the copy stream, read on this one
        return dev


def _run_from_disk(args, device: torch.device) -> None:
    """End to end from mp4 files on disk: every iteration decodes a fresh
    batch (``data/video.process_video``) in a one-ahead worker thread that
    also uploads it, while the card runs the pipeline. By default the host
    only decodes: raw uint8 frames go up and ``DeviceSiglipPreprocessor``
    pads, resizes and normalizes them on the card, before the tower;
    ``--host-preprocess`` preprocesses on the host
    (``data/processor.SiglipImagePreprocessor``) as the reference's loader
    does. The detail separates the ingest-only rate, the card-only rate on a
    resident batch and one ingest plus its upload, so the limiter shows."""
    from .data.processor import SiglipImagePreprocessor
    from .data.video import process_video
    from .ops.preprocess import DeviceSiglipPreprocessor

    dev = device_detail(device)
    reset_peak(device)
    arm = _make_arm(args, args.tower_quant, args.dec_quant, device)
    b, t = arm.b, arm.t
    img = arm.cfg.vision_config.image_size
    dtype = arm.frames.dtype
    device_pre = not args.host_preprocess
    with tempfile.TemporaryDirectory(prefix="hicom_fromdisk_") as pool_dir:
        n_pool = max(2 * b, 8)
        paths = [os.path.join(pool_dir, f"clip{i}.mp4") for i in range(n_pool)]
        for i, p in enumerate(paths):  # a sanity run writes 1 s clips
            write_realistic_mp4(p, seconds=1.0 if args.small else 6.0, seed=i)
        proc = SiglipImagePreprocessor(size=(img, img))

        def ingest_host(i):
            """disk -> host-preprocessed (b, t, 3, img, img) float32."""
            return np.stack([process_video(paths[(i * b + j) % n_pool], processor=proc, num_frames=t)
                             for j in range(b)])

        def ingest_raw(i):
            """disk -> raw decoded (b, t, h, w, 3) uint8: no host pixel math."""
            return np.stack([process_video(paths[(i * b + j) % n_pool], processor=None, num_frames=t)
                             for j in range(b)])

        if device_pre:
            pre = DeviceSiglipPreprocessor(size=(img, img), out_dtype=dtype, device=device)
            uploader = Uploader(device, None)
            ingest_batch = ingest_raw

            @torch.inference_mode()
            def run(raw):
                n, tt, h, w, _ = raw.shape
                frames = pre(raw.reshape(n * tt, h, w, 3))["pixel_values"].reshape(n, tt, 3, img, img)
                return arm(frames)
        else:
            uploader = Uploader(device, dtype)
            ingest_batch = ingest_host
            run = arm

        # ingest alone, serially, on the same videos: the host's rate
        ingest_batch(0)
        g0 = time.perf_counter()
        for i in range(3):
            ingest_batch(i)
        ingest_fps = 3 * b * t / (time.perf_counter() - g0)
        if device.type == "cuda":
            log(f"ingest-only ({'raw' if device_pre else 'host-preprocess'}): {ingest_fps:.1f} frames/s")

        resident = Uploader.take(uploader.put(ingest_batch(0)))
        _warm_arm(lambda: run(resident), args.sync_every)
        # one ingest and its upload
        u0 = time.perf_counter()
        Uploader.take(uploader.put(ingest_batch(1)))
        upload_ms = (time.perf_counter() - u0) * 1e3
        # the card alone on a resident batch: the compute term of the bound
        chip_fps = b * t / median(_time_groups(lambda: run(resident), args.sync_every * 2, args.sync_every))

        before = stamp(device)
        reset_launches()
        group_dts = []
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            nxt = ex.submit(lambda: uploader.put(ingest_batch(0)))
            it = 0
            for _ in range(max(1, args.iters // args.sync_every)):
                g0 = time.perf_counter()
                acc = None
                for _ in range(args.sync_every):
                    frames = Uploader.take(nxt.result())
                    it += 1
                    nxt = ex.submit(lambda i=it: uploader.put(ingest_batch(i)))
                    out = run(frames)
                    acc = out if acc is None else acc + out
                acc.item()
                group_dts.append((time.perf_counter() - g0) / args.sync_every)
            nxt.result()
        launches = read_launches()
        card = stamps(device, before)
    fps = b * t / median(group_dts)
    result = {
        "metric": "video_frames_per_sec_per_chip_from_disk",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / max(ingest_fps, 1e-9), 3),
        "detail": {
            "ingest_mode": "device_preprocess" if device_pre else "host_preprocess",
            "pipelined_from_disk_fps": round(fps, 2),
            "ingest_only_fps": round(ingest_fps, 1),
            "chip_only_fps": round(chip_fps, 1),
            # with the upload overlapped, the pipeline's bound is its slower stage
            "analytic_production_host_fps": round(min(ingest_fps, chip_fps), 1),
            "upload_plus_one_ingest_ms": round(upload_ms, 1),
            "group_ms": [round(g * 1e3, 1) for g in group_dts],
            "batch_videos": b, "frames_per_video": t,
            "config": _config_name(args),
            "baseline_model": "ingest-only rate (vs_baseline ~1.0 = fully ingest-overlapped)",
            "device": dev,
            "peak_gb": peak_gb(device),
            "kernel_launches": launches,
            "card_stamp": card,
        },
    }
    emit(result, device)


# --------------------------------------------------------------------------- #
# Entry point
# --------------------------------------------------------------------------- #


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 -m hicom_tpu_torch.bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="tiny configuration: a sanity run of the mode")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits without a card), or cpu with --small only")
    ap.add_argument("--batch", type=int, default=4,
                    help="videos per step (4: batched serving; 1: the reference's serving shape)")
    ap.add_argument("--model", choices=("1.5b", "7b"), default="1.5b",
                    help="decoder widths; 7b runs Qwen2.5-7B's with an int8 weight-only decoder")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the tower and the decoder to this many layers each: a quick check of the mode at "
                         "its widths (chip_smoke.py's [bench]), not a measurement of the configuration")
    ap.add_argument("--modal", choices=("video", "image"), default="video",
                    help="image: the single-image pipeline (113 visual tokens); use a larger --batch "
                         "(e.g. 32), one image being 1/32 of a video's tower work")
    ap.add_argument("--iters", type=int, default=16,
                    help="timed iterations, --sync-every per group; the headline is the median group")
    ap.add_argument("--iters-bf16", type=int, default=8, help="timed iterations of the bf16 arm")
    ap.add_argument("--sync-every", type=int, default=4, help="iterations queued per host read")
    ap.add_argument("--no-bf16-arm", action="store_true",
                    help="skip the bf16-numerics arm timed after the headline in the same run")
    ap.add_argument("--tower-quant", choices=("none", "w8a8", "w8a8_mlp", "w8a8_mlp_qkv",
                                              "w8a8s", "w8a8s_mlp", "w8a8s_mlp_qkv"),
                    default="w8a8s_mlp_qkv",
                    help="serving-tower quantization (default w8a8s_mlp_qkv: int8 fc1/fc2 and q/k/v with "
                         "calibrated static activation scales; 'none' = bf16)")
    ap.add_argument("--dec-quant", choices=("none", "int8", "w8a8", "w8a8_mlp", "w8a8s", "w8a8s_mlp"),
                    default="w8a8",
                    help="decoder quantization of the prefill (default w8a8: int8 products with dynamic "
                         "activation scales; w8a8s*: calibrated static scales)")
    ap.add_argument("--decode", action="store_true",
                    help="decode steps at b in {1, 4, 8} instead of the prefill metric")
    ap.add_argument("--train", action="store_true",
                    help="the train step at the serving shape (remat, flash forward and backward): step ms, "
                         "target tokens/s, achieved TFLOP/s and MFU")
    ap.add_argument("--kv-int8", action="store_true", help="decode mode: int8 KV cache")
    ap.add_argument("--train-parts", default="mm_projector",
                    help="train mode: mm_tunable_parts (default: the stage-1 projector pretrain)")
    ap.add_argument("--bits", type=int, default=16, choices=(4, 8, 16),
                    help="train mode: QLoRA, an NF4 (4) or int8 (8) frozen decoder with LoRA adapters")
    ap.add_argument("--lora-r", type=int, default=64, help="train mode with --bits 4/8: LoRA rank")
    ap.add_argument("--from-disk", action="store_true",
                    help="end to end from mp4 files on disk, decoded on the host while the card computes")
    ap.add_argument("--host-preprocess", action="store_true",
                    help="from-disk mode: preprocess on the host instead of on the card")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    args._t0 = time.monotonic()
    if args.train and args.model == "7b" and args.bits == 16:
        ap.error("--train --model 7b at 16 bits would train over the 7b configuration's int8 weight-only "
                 "decoder; the 7B train step on one card is QLoRA: add --bits 4 (NF4) or --bits 8 (int8)")
    if args.bits != 16 and not args.train:
        ap.error("--bits 4/8 selects the QLoRA train step; it requires --train")
    device = torch.device(args.device)
    if device.type == "cpu" and not args.small:
        ap.error("--device cpu runs the --small sanity run only: the measurements need the card")
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.exit(2, f"{ap.prog}: no CUDA device (the CPU sanity run: --small --device cpu)\n")
    runner = (_run_train if args.train else
              _run_decode if args.decode else
              _run_from_disk if args.from_disk else _run)
    runner(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
