#!/usr/bin/env python3
"""Drive the PyTorch port (hicom_tpu_torch) on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: every kernel of hicom_tpu_torch/csrc, one nvcc per source, in parallel;
  3. each kernel against its plain PyTorch version at the main paths' shapes, in
     bf16, with its time, the plain version's, a PyTorch library call's where one
     computes the same function, and the card's bound for the same work (the
     decoder prefill at the 7B and 1.5B widths; the global compressor's
     forward at b 1 and b 2 and its dQ split over the keys, with each
     launch's grid; the forward at a small masked shape with forced
     splits of 1, 2, 3 and 7; the split path's merge and dQ-sum kernels alone;
     the flash backward's dQ, dK and dV at the 7B and 1.5B decoder, global
     compressor and tower shapes, with each launch's grid, dK and dV also with forced splits
     of 1, 2 and 7 at the decoder shape and their sum pass alone; the decode
     kernel at b 2 and at b 1, with an int8 cache, and on a bitmap row with no
     valid slot; the tile kernel at b 1 and b 2 in the main path's call form,
     in the clip-scale form, and on the image tile; and the shapes of the
     CLIP and anyres configurations: K1 over 577 tokens at d 64 and over an
     anyres image's 16 crops, K2 on the 7,333-token anyres prefill and the
     CLIP global compressor, K3 over an 8,192-slot cache, K4 at qk 768 /
     dv 1024 and on an anyres patch grid, K5/K6 at the anyres train step;
     and Qwen2.5-0.5B's: K2 at its prefill and K3 at head dim 64, group 7,
     with a bf16 and an int8 cache, and K3 at groups 5 and 3); and the fp32
     instances at [fp32-serve]'s shapes (K1 over the tower's 512 rows of
     729, K2 at the 7B prefill and at the global compressor's b 1 with its
     fp32 merge, the merge alone, K4 at b 1, in the main path's and the
     clip-scale form), held to their fp32 plain versions at the fp32 gate
     (2^-14 |ref| + 2^-14 rms), with SDPA in fp32 beside them; K1 and K2 at
     head dims 16 and 96 in bf16 and fp32 (checks only); the flash backward
     in fp32 at [fp32-train]'s shapes (K5 and K6 at the 7B decoder and the
     global compressor's b 2, the sum pass writing fp32) at the fp32 gate,
     with SDPA's fp32 backward beside them, and K5/K6 at head dims 16, 48, 96
     and 112 in bf16 and at 16 and 96 in fp32 (checks only); and past head
     dim 128, in bf16 and fp32: K1 over 64 rows of 729 at d 192 and 256
     (checks only), K2, K5 and K6 at [hd256]'s prefill (b 2, 14 / 2 heads of
     256, 743 tokens, causal, lengths 743 / 700) and at d 192, K2 forced to 3
     splits with its merge, K6 to 1 and 7 and K5 to 3, the merge and both sum
     passes over d-256 rows; and past head dim 256 (the wide kernels,
     ``flash_wide.cu`` and ``flash_wide_f32.cu``), in bf16 and fp32: K1 over
     64 rows of 729 at d 288, 320, 512 and 1,024, K2, K5 and K6 at [hd512]'s
     prefill (b 2, 7 / 1 heads of 512, 743 tokens, causal, lengths 743 / 700),
     K2 forced to 3 splits with its merge, K6 to 1 and 7 and K5 to 3, both sum
     passes and the merge over d-512 rows, and K2, K5 and K6 at d 320 (8 / 2
     heads) and d 1,024 (4 / 1 heads) over the same prefill;
  4. serving at the full width of the released HICom-7B (SigLIP-so400m,
     local43_global32 with direct guide, Qwen2.5-7B in bf16, weights from a seed
     on the card): 3 requests of a 32-frame 384x384 video through
     ``HICom.generate`` (a right-padded batch of 2, then one alone), greedy, 16
     new tokens; every kernel's launch count must rise; then one projector
     forward under torch.cuda.set_sync_debug_mode("error"), which fails on any
     call that waits for the device; then [serve-engine] on the same model:
     ``mm_serve``'s continuous-batching engine (4 slots, a 4,096-slot cache,
     16 steps a round, buckets 64-512) takes 8 requests (5 videos of 32
     frames, an image, 2 text prompts; budgets 8-32; one stop sequence)
     eagerly, with each round one CUDA graph, with graphed rounds and
     spec_k=3 (adaptive and forced), and through ``mm_serve`` (the decoder's
     norm weights set to 1 first, so that greedy streams vary): graphed
     streams equal eager ones bit
     for bit, speculative ones equal plain ones, each equals the request's
     standalone ``HICom.generate`` but at near-ties (top-2 gap <= 2^-6 of the
     top logit), one admission and one graphed round pass the sync check,
     K1-K4 launch (K3 counted per replay); it prints aggregate tokens/s, ms
     per round, submit-to-first-token per request, the speculative
     acceptance, peak memory and the idle share of an eager and a graphed
     round; K3 is also checked at the engine's shape (b 4, per-slot masks);
     then [seq-parallel] on the same model in a one-rank NCCL group:
     [long-video] (a 128-frame video through ``HICom.encode_long_video``,
     and a 4-rank run's shares taken in turn with their global compressor's
     fp32 partials merged once, against ``encode_visual``), [ring-prefill]
     (16,384 seeded embeddings through ``ring_prefill`` over 28 layers
     against the direct prefill; one layer split as an 8-rank ring splits
     it, 36 K2 blocks and 8 merges, against one causal K2;
     ``HICom._generate_ring`` of the 128-frame prompt against ``generate``)
     and [pipeline] (``pipeline_prefill`` at pp 1 against the decoder
     forward); K2's partials are also checked at the ring's block shape
     (2,048 x 2,048, causal and full), and the merge wrapper at the 8-rank
     ring's; then, in the same group, [mesh-serve] (``ServeEngine(mesh=
     world_mesh())`` at tp 1 over [serve-engine]'s 8 requests, graphed with
     the tp collectives captured in the round graphs: streams equal to
     [serve-engine]'s graphed ones bit for bit, the collectives a captured
     round holds, the graphed round beside [serve-engine]'s, K1-K4
     launched, and the caller's model still giving those streams after)
     and [eval-dp] (``HICom.shard_for_eval()`` and ``mm_infer_batch`` over 4
     videos of 8 frames: the unsharded call's strings); K1, K2 and K3 are
     also checked at a tp-2 rank's head shards (8 tower heads, 14/2 decoder
     heads at the prefill and at the engine's decode);
  4b. [clip]: the same 3 requests (336x336 frames) through HICom-7B on the
     CLIP-L/336 tower at its published widths (K1 at d 64, K4 with 768-wide
     keys and 1024-wide values); [anyres]: the reference's llava1.5 anyres
     configuration (mlp2x_gelu, anyres_max_9, (1x1),...,(6x6)) answers a
     1920x1080 and a 1024x1024 image through ``mm_infer(..., image_size=...)``
     (16 and 10 crops, 7,270 and 7,372 visual tokens, an 8,192-slot cache),
     with its stage breakdown and one merge + projector under the sync check;
  4c. [baseline-0.5b]: ``BASELINE.json`` configs 1-2, HICom on so400m with
     local compression only (local43) and the direct guide over
     Qwen2.5-0.5B's published widths at full depth (24 layers, 14 / 2 heads
     of 64, tied embeddings): phase 4's main path on 8-frame requests, the
     single request's greedy ids and last-token logits against the plain path
     on the card, and one single-image request (K4 on 1 x 3 x 3 tiles);
     [fp32-route]: a model at ``selftest.py``'s tiny widths in fp32 (decoder
     head dim 16) through ``model_init`` + ``mm_infer`` on the card and on the
     CPU, the same string, its decode steps on the plain path by K3's contract;
     [fp32-serve]: HICom-7B in fp32 at full width and depth (norms at 1),
     phase 4's 3 requests with K1, K2 (split and merged at the global
     compressor) and K4 launched as often as the model's depth gives, every
     decode step on the plain path by K3's contract (28 a step), then 8
     greedy ids equal to the plain path's on the card and last-token logits
     within the fp32 gate; TTFT, decode rate, stages, peak memory;
     [fp32-train]: 3 stage-2 steps of HICom-7B in fp32 at full width and
     depth, the flash backward (its fp32 instance) 29 times a step, step 1's
     trained gradients within the fp32 gate of the plain path's, frozen
     tensors' bits kept, trained tensors moved; step ms and peak memory;
     [hd256]: HICom-7B with its decoder reshaped to 14 / 2 heads of 256
     (Qwen2.5-7B's projection sizes; a width variant, not a published
     checkpoint) at 4 layers, norms at 1: phase 4's 3 requests (K2 at d 256
     per decoder layer, every decode step on the plain path by K3's
     contract), 8 greedy ids and last-token logits against the plain path on
     the card (past the gate, both against the fp32 plain path on the same
     weights), then 2 stage-2 steps with K5/K6 at d 256, step 1's gradients
     against the plain path's; [hd512]: the same with the decoder at 7 / 1
     heads of 512 and the SigLIP tower at 4 heads of 288 (so400m's 1,152
     width; its 729-token attention on K1 at d 288 by JAX's one-block rule),
     the prefill on K2 and the backward on K5/K6 at d 512 (the wide kernels);
  5. training at the same width: 3 stage-2 steps (projector and guide injectors
     trained, towers and decoder frozen) on a seeded batch of 2, with finite
     losses, frozen weights bit-identical, trained weights moved, 29 flash
     backward launches per step and no tile-kernel launch; then one step split
     into stages and one under torch.profiler (device time by kernel and by the
     aten op that launched it); then [mesh-train], the same 3 steps through
     the mesh path in a one-rank NCCL group (``init_distributed``,
     ``create_mesh(1, 1, 1)``, ``create_sharded_state``: the rules' tp plan
     and FSDP2 ``fully_shard``), losses, target tokens and grad norms
     bit-equal to [train]'s, 29 flash backward launches per step, frozen
     tensors unmoved, the step time beside [train]'s;
  5b. stage 3 through LoRA (r 128, alpha 256, remat) at the same width and
     depth: 3 steps, the base bit-identical, every adapter moved, 28 flash
     backward and 57 flash forward launches per step;
  5c. full stage-3 SFT at the width and depth of the 1.5B configuration: 3
     steps, the tower trunk bit-identical, every trained tensor (tower head,
     guide encoder, projector, decoder) whose gradient reaches AdamW's eps
     moved, 29 flash forward and 29 flash backward launches per step; then
     [stage3-sft-offload], the same steps with the AdamW moments in pinned
     host memory (``offload_optimizer=True``): masters equal to the resident
     run's (each element within one fp32 ulp), the same losses, the pinned
     bytes within 10% of the moments';
  5d. [anyres-train]: 3 projector steps of the anyres configuration (remat)
     on 2 rows sharing the 1920x1080 plan; [multi-image]: 3 stage-2 steps of
     HICom-7B on rows of 2 images;
  6. with 2 decoder and 2 tower layers, the kernel path against the plain path:
     last-token prefill logits, and the trained parameters' gradients; for the
     anyres and CLIP configurations also 8 greedy ids (decode on the plain
     twin too), and the anyres projector's gradients;
  7. the trainer's CLI from files at 7B width with 2 tower and 2 decoder
     layers: stage 2, stage 3 LoRA, stage 3 QLoRA over an int8 base
     (``--bits 8``) and stage 3 SFT, the last again with
     ``--offload-optimizer`` (its losses and ``hf_export`` equal to the
     flagless run's), each artifact loaded by ``load_model``
     in its own layout, held to the model that wrote it (for ``--bits 8``,
     the float stage-2 base with the trained adapters as a side path) and
     generating through K1-K4; then [mesh-cli]: stage 2 again through
     ``python -m torch.distributed.run --nproc_per_node 1 -m
     hicom_tpu_torch.train.cli ... --dp 1 --fsdp 1 --tp 1`` (NCCL), its
     losses and ``mm_projector.bin`` equal to [cli]'s;
  7b. [closed-loop]: the port's selftest loop (train -> export -> reload ->
     eval -> score) at the same width and depth, in bf16 with 8 frames:
     stage 1 and stage 2 through ``train.cli.main`` on the selftest's images
     and mp4s, the stage-2 export through the port's eval runner on a mini
     Video-MME whose answer is always "B" (which stage 2 teaches), scored at
     least 75.0 (chance 25.0), and again under the int8 weight-only and
     ``serving_default`` quantization with the fp accuracy; K1-K6 all launch;
     then the runner once more with ``--dtype float32`` (at least 75.0, K1,
     K2 and K4 launched in fp32);
  8. the quantized serving configuration from raw frames (``models/quant.py``,
     ``ops/preprocess.py``): [quant-ops] the int8 routes (``torch._int_mm``
     bit-equal to the exact product at the tower MLP and decode shapes; the
     int8 and NF4 linears against their dequantized products; the device
     preprocess against the CPU's), each beside bf16 ``torch.matmul``;
     [serve-int8] HICom-7B at full width and depth with bench.py's int8
     weight-only decoder, fed 32 raw 360x640 uint8 frames per request through
     ``process_video(processor=None)`` and ``DeviceSiglipPreprocessor``, for
     the 3 requests of phase 4, with its logits beside the bf16 model's;
     [serve-w8a8] the same with a ``w8a8s_mlp_qkv`` tower and a ``w8a8s``
     decoder calibrating on their first request; both gated by a 2-layer
     comparison with the plain path on the card on the same weights;
     [model-init] ``model_init(..., device_preprocess=True)`` + ``mm_infer``
     from an exported checkpoint under each quantization flag, the card's
     string equal to the CPU's for the int8 decoder (``load_8bit``) and to
     the plain path's on the card for the others;
     [stage3-qlora] 3 stage-3 steps over an NF4 base;
  8b. [bench]: ``python3 -m hicom_tpu_torch.bench`` at full width with the
     tower and decoder cut to 4 layers (``--layers 4``), one
     subprocess per mode, the four at once (a check, not a measurement):
     the default (w8a8s_mlp_qkv tower and w8a8 decoder,
     then the bf16 arm; 8 and 4 timed iterations), ``--decode``, ``--train``
     and ``--from-disk`` (4 each); each last JSON line names the card, has a
     positive value, MFU in (0, 100], both arms in the default, and positive
     launches of K1, K2 and K4 (prefill modes), K3 (decode) or K5/K6 (train);
  9. [stage3-sft-7b-offload] (last): full stage-3 SFT of HICom-7B at full
     width and depth with the AdamW moments in pinned host memory, remat,
     batch 1, 3 steps: the link's own rate, the pinned bytes against the
     moments', step ms split into forward + loss, backward and update, the
     update against its link bound, the peak against the card's memory; the
     frozen tensors' bits, moved masters in every part, and a sample
     of tensors' masters and moments against ``torch.optim.AdamW``'s step.

After every phase but [fp32-route], no decode step went to the plain path
by K3's contract (``cuda_build.plain_route``: every other phase runs bf16 at
head dims and groups K3 takes, or counts its decode steps that K3 does not
take, fp32 or at head dim 256 or 512, and resets: [fp32-serve], [hd256], [hd512],
[closed-loop]'s fp32 call). Prints one line per check, then a JSON object with
the kernels (each row at a shape of the main paths, its launches counted in the
phase that runs that shape: serving, [serve-engine], [ring-prefill], stage 2,
the 1.5B stage 3, [clip], [anyres], [anyres-train], [baseline-0.5b] and its
image request, [fp32-serve], [hd256] or [hd512]), then the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any
failure exits non-zero before that last line. Without a CUDA device, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np

# H100 data-sheet peaks (dense bf16 tensor-core FLOP/s, HBM bytes/s) by card name
PEAKS = {"PCIe": (756e12, 2.0e12), "NVL": (835e12, 3.9e12), "": (989e12, 3.35e12)}
FP32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores (the split path's second passes)
TF32_PEAK = 495e12  # H100 SXM dense TF32 FLOP/s on the tensor cores (the wide fp32 kernels: 3xTF32)
# kernel: (the count its row reports: its wrapper's launches, or, past head dim 256, the launches of its
# (kernel, library) in flash_attention.source_launches; source; the TPU kernel it replaces)
KERNELS = {
    "K1": ("fullblock_attention", "hicom_tpu_torch/csrc/flash_fwd.cu", "hicom_tpu/ops/flash_attention.py:141"),
    "K2": ("flash_forward", "hicom_tpu_torch/csrc/flash_fwd.cu", "hicom_tpu/ops/flash_attention.py:31"),
    "K3": ("flash_decode", "hicom_tpu_torch/csrc/flash_decode.cu", "hicom_tpu/ops/flash_decode.py:32"),
    "K4": ("fused_tile_attention", "hicom_tpu_torch/csrc/local_attn.cu", "hicom_tpu/ops/local_attn.py:26"),
    "K5": ("flash_backward", "hicom_tpu_torch/csrc/flash_bwd.cu", "hicom_tpu/ops/flash_attention.py:262"),
    "K6": ("flash_backward", "hicom_tpu_torch/csrc/flash_bwd.cu", "hicom_tpu/ops/flash_attention.py:309"),
}
# the split path's second passes run inside the K2 and K5 wrappers and count with them
KERNELS["K2-merge"] = KERNELS["K2"]
# the merge kernel alone over ranks' or ring blocks' partials counts in its own wrapper
KERNELS["K2-merge-ranks"] = ("merge_partials",) + KERNELS["K2"][1:]
# the sum pass (flash_part_sum.cuh) runs inside the K5 and K6 wrappers, bf16 or fp32, and counts with them
KERNELS["K5-sum"] = ("flash_backward", "hicom_tpu_torch/csrc/flash_part_sum.cuh", KERNELS["K5"][2])
KERNELS["K6-sum"] = ("flash_backward", "hicom_tpu_torch/csrc/flash_part_sum.cuh", KERNELS["K6"][2])
# the fp32 instances, in their own sources
for _k, _src in (("K1", "flash_fwd_f32"), ("K2", "flash_fwd_f32"), ("K5", "flash_bwd_f32"), ("K6", "flash_bwd_f32")):
    KERNELS[f"{_k}-f32"] = (KERNELS[_k][0], f"hicom_tpu_torch/csrc/{_src}.cu", KERNELS[_k][2])
KERNELS["K5-f32-sum"], KERNELS["K6-f32-sum"] = KERNELS["K5-sum"], KERNELS["K6-sum"]
# past head dim 256: the wide kernels, one source per type, counted by (kernel, library) where they launch,
# apart from the same wrappers' launches at other head dims (the global compressor's d 128)
for _k in ("K1", "K2", "K5", "K6"):
    for _f, _lib in (("-wide", "flash_wide"), ("-wide-f32", "flash_wide_f32")):
        KERNELS[f"{_k}{_f}"] = ((_k, _lib), f"hicom_tpu_torch/csrc/{_lib}.cu", KERNELS[_k][2])
        if _k in ("K5", "K6"):  # the sum pass, run by the wide entry point when split
            KERNELS[f"{_k}{_f}-sum"] = ((f"{_k}-sum", _lib), KERNELS[f"{_k}-sum"][1], KERNELS[_k][2])
TRAIN_STEPS = 3
# [baseline-0.5b]'s batch of 2: prompts of 64 and 41 ids, each with its <video> sentinel replaced by the 162
# visual tokens of 8 frames (local43: 2 x 9 x 9 tiles); the spliced lengths, which its K2 and K3 rows take
BASELINE_PREFILL = (64 - 1 + 162, 41 - 1 + 162)
# what [slice] leaves for [serve-int8]: the bf16 model's logits and tower time
BF16_REFERENCE = {}
# the run whose launch counts a kernel row reports, by default: the serving
# phase for the forward kernels, stage 2 for the backward
DEFAULT_PHASE = {"fullblock_attention": "serve", "flash_forward": "serve", "flash_decode": "serve",
                 "fused_tile_attention": "serve", "flash_backward": "train"}


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


# (relative, of rms) factors of the kernels' gates: bf16 and fp32 (see agreement)
BF16_GATE = (2**-6, 2**-5)
FP32_GATE = (2**-14, 2**-14)


def agreement(got, ref, gate=BF16_GATE):
    """A kernel's output against its plain version's.

    bf16 (``BF16_GATE``): each element may differ by 2^-6 |ref| + 2^-5
    rms(ref): two bf16 ulps of its own value (both sides round the output; the
    kernel rounds or sums p at another running max than the plain version),
    plus a 32nd of the output's typical size for elements near zero, whose
    error is that of the row's sum of rounded terms. fp32 (``FP32_GATE``, the
    fp32 instances and the fp32 serving path): 2^-14 |ref| + 2^-14 rms(ref),
    512 fp32 ulps of the value, where both sides keep every operand in fp32
    and differ by the order of their sums; a TF32 (10-bit mantissa) or bf16
    operand anywhere exceeds it (``tests/test_torch_fp32_kernels.py``). Rows
    above either gate are decided by :func:`float64_referee` where they have
    an exact version. Returns (max abs error, worst error/tolerance,
    rms(ref), max |ref|); the check passes when the worst ratio is at most 1."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    rms = ref.square().mean().sqrt()
    ratio = (err / (gate[0] * ref.abs() + gate[1] * rms)).max()
    return err.max().item(), ratio.item(), rms.item(), ref.abs().max().item()


def gate_text(gate) -> str:
    return f"2^{int(np.log2(gate[0]))}|ref| + 2^{int(np.log2(gate[1]))} rms"


def float64_referee(got, plain, exact, mantissa: int = 7):
    """The check of a kernel row that exceeds :func:`agreement`'s gate where
    both sides are as far from the exact answer: the kernel's bf16 output
    and the plain version's, each against the float64 plain version on the
    same inputs. The kernel's largest error may exceed the plain version's by
    an eighth plus one ulp (of a ``mantissa``-bit type: 7 for bf16, 23 for
    fp32) of the element where it is largest (the two round the output on
    either side of a value), and its rms error the plain version's by an
    eighth. Returns (kernel's max error, plain's, that ulp, kernel's rms
    error, plain's, passes)."""
    import torch

    ek, ep = (got.double() - exact).abs(), (plain.double() - exact).abs()
    at = exact.flatten()[ek.argmax()].abs().clamp_min(2**-126)
    ulp = (2.0 ** (torch.floor(torch.log2(at)) - mantissa)).item()
    rk, rp = ek.square().mean().sqrt().item(), ep.square().mean().sqrt().item()
    mk, mp = ek.max().item(), ep.max().item()
    return mk, mp, ulp, rk, rp, mk <= (1 + 2**-3) * mp + ulp and rk <= (1 + 2**-3) * rp


def kernel_checks(card: str, wide_only: bool = False):
    """Phase 3: returns {entry name: (kernel id, phase, record)} for the JSON
    line, ``phase`` naming the run of the main paths that gives the kernel this
    row's shape and whose launch count the row reports. Rows at a shape or call
    form that no phase runs (forced split counts, the int8 cache, the
    clip-scale form, the backward at the tower shape) are checks only: they
    print their line and fail the run on a disagreement, and stay out of the
    JSON line. ``wide_only``: the rows past head dim 128 alone
    (:func:`head_dim_checks`)."""
    import torch
    import torch.nn.functional as F

    from hicom_tpu_torch.ops.flash_attention import (FWD_BLOCK_Q, WIDE_BLOCK_Q, WIDE_FROM, _launch, flash_forward,
                                                     flash_forward_partials, flash_partials_reference,
                                                     flash_reference, forward_splits, fullblock_attention,
                                                     wide_column_blocks)
    from hicom_tpu_torch.ops.flash_decode import DECODE_CHUNK, decode_reference, flash_decode
    from hicom_tpu_torch.ops.grouping import tile_thw
    from hicom_tpu_torch.ops.local_attn import fused_tile_attention, tile_reference

    peak_flops, peak_bw = next(v for k, v in PEAKS.items() if k in card)
    dev = "cuda"
    gen = torch.Generator(dev).manual_seed(1)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    records = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def fwd_grid(b, H, Lq, Lk, d, n_split=None, fp32=False):
        """The forward kernel's grid at head dim ``d``: blocks of 128 query
        rows (64 in fp32, and past 256, where z also counts the column
        blocks), times the key chunks on z."""
        rows = WIDE_BLOCK_Q if d > WIDE_FROM else 64 if fp32 else FWD_BLOCK_Q
        splits = n_split or forward_splits(b, H, Lq, Lk, sms, d=d, dtype=torch.float32 if fp32 else torch.bfloat16)
        return -(-Lq // rows), b * H, splits * wide_column_blocks(d, "fwd")

    def record(name, kid, kernel_fn, plain_fn, library_fn, flops, nbytes, valid=None, outputs=1, grid=None,
               flops_rate=None, phase="", exact_fn=None, gate=BF16_GATE):
        """Hold the first ``outputs`` tensors of the kernel's result to the plain
        version's (or the one selected by ``outputs``, a tuple of indices).
        ``grid`` is the kernel launch's (x, y, z), printed with its blocks;
        ``flops_rate`` the peak for ``flops`` when they are not bf16 products;
        ``phase`` the run that gives the kernel this shape (default
        ``DEFAULT_PHASE``; None: a check only). ``exact_fn`` (one output only)
        gives the float64 answer: where the gate is exceeded, the row passes
        only if :func:`float64_referee` finds the kernel no further from it
        than the plain version. ``gate``: :data:`BF16_GATE`, or
        :data:`FP32_GATE` for an fp32 instance."""
        got, ref = kernel_fn(), plain_fn()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        idx = outputs if isinstance(outputs, tuple) else tuple(range(outputs))
        worst = (0.0, -1.0, 0.0, 0.0)
        for g, r in zip(got, (ref[i] for i in idx)):
            if valid is not None:
                g, r = g[valid], r[valid]
            worst = max(worst, agreement(g, r, gate), key=lambda a: a[1])
        err, ratio, rms, top = worst
        bound_c, bound_b = flops / (flops_rate or peak_flops) * 1e3, nbytes / peak_bw * 1e3
        rec = dict(name=name, route="cuda", source=KERNELS[kid][1], replaces=KERNELS[kid][2],
                   launches=None, max_abs_err=err, ms=cuda_ms(kernel_fn), plain_ms=cuda_ms(plain_fn, iters=3),
                   bound_ms=max(bound_c, bound_b), bound_by="operations" if bound_c >= bound_b else "bytes",
                   library_ms=cuda_ms(library_fn) if library_fn is not None else None)
        phase = DEFAULT_PHASE[KERNELS[kid][0]] if phase == "" else phase
        records[name] = (kid, phase, rec)
        log(f"[kernel] {name}: max_abs_err {err:.3g}, worst err/tol {ratio:.3f} (tol {gate_text(gate)}, "
            f"ref rms {rms:.3g}, max {top:.3g}) | kernel {rec['ms']:.4f} ms | plain "
            f"{rec['plain_ms']:.4f} ms | library {rec['library_ms'] if rec['library_ms'] is None else round(rec['library_ms'], 4)} ms"
            f" | bound {rec['bound_ms'] * 1e3:.1f} us ({rec['bound_by']})"
            + (f" | grid {'x'.join(map(str, grid))} = {int(np.prod(grid))} blocks" if grid else "")
            + (f" | launches from [{phase}]" if phase else " | a check only"))
        if ratio <= 1:
            return
        if exact_fn is None:
            raise AssertionError(f"{name}: kernel disagrees with its plain version (worst err/tol {ratio})")
        exact = exact_fn()
        sel = (lambda x: x[valid]) if valid is not None else (lambda x: x)  # noqa: E731
        ek, ep, ulp, rk, rp, ok = float64_referee(sel(got[0]), sel(ref[0]), sel(exact), 23 if gate == FP32_GATE else 7)
        log(f"[referee] {name}: the gate is exceeded ({ratio:.3f}); against float64: max error kernel {ek:.4g}, "
            f"plain {ep:.4g}, one ulp at the kernel's worst element {ulp:.4g}; rms error kernel {rk:.4g}, "
            f"plain {rp:.4g} | {'passes' if ok else 'FAILS'} (kernel <= (1 + 2^-3) plain + 1 ulp, rms <= "
            "(1 + 2^-3) plain's)")
        if not ok:
            raise AssertionError(f"{name}: kernel further from float64 than its plain version (max {ek:.4g} "
                                 f"against {ep:.4g}, rms {rk:.4g} against {rp:.4g})")

    if wide_only:
        head_dim_checks(record, fwd_grid, sms, UP_TO_256)
        head_dim_checks(record, fwd_grid, sms, PAST_256)
        return {name: r for name, r in records.items() if r[1] is not None}

    # K1: SigLIP tower self-attention, 32 frames x 16 heads, L = 729, d = 72; and one tp-2 rank's 8 heads
    # ([mesh-serve] runs tp 1 on one card: a check only)
    for label, heads, phase in (("siglip 32f", 16, ""), ("siglip 32f tp2 shard", 8, None)):
        bh, L, d = 32 * heads, 729, 72
        q, k, v = rn(bh, L, d), rn(bh, L, d), rn(bh, L, d)
        # the library call on 4-D (bh, 1, L, d) tensors: SDPA's fused backends take only 4-D inputs
        # (on 3-D ones it falls back to the math path, which writes out every score)
        record(f"fullblock_attention[{label}]", "K1",
               lambda: fullblock_attention(q, k, v, d**-0.5),
               lambda: flash_reference(q[:, None], k[:, None], v[:, None], None, d**-0.5, 0.0, False)[0][:, 0],
               lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], scale=d**-0.5),
               4 * bh * L * L * d, 4 * bh * L * d * 2 + bh * L * 4, grid=fwd_grid(bh, 1, L, L, d), phase=phase)
        del q, k, v

    # K2 prefill: 28 q / 4 kv heads (7B), a tp-2 rank's 14 / 2 of them (a check only) and 12 / 2 (1.5B),
    # L = 743 (64-token bucket - 1 + 680), causal, a right-padded row (kv_lengths 700) beside a full one
    for label, H, KVH in (("7b", 28, 4), ("7b tp2 shard", 14, 2), ("1.5b", 12, 2)):
        b, L, d = 2, 743, 128
        lens = [743, 700]
        q, k, v = rn(b, H, L, d), rn(b, KVH, L, d), rn(b, KVH, L, d)
        kl = torch.tensor(lens, device=dev, dtype=torch.int32)
        pos = torch.arange(L, device=dev)
        mask = (pos[None, :] <= pos[:, None])[None, None] & (pos[None, None, None, :] < kl[:, None, None, None])
        valid = (pos[None, :] < kl[:, None])[:, None, :].expand(b, H, L)
        pairs = sum(int(np.minimum(n, np.arange(L) + 1).sum()) for n in lens)
        record(f"flash_forward[prefill {label}]", "K2",
               lambda: flash_forward(q, k, v, kl, d**-0.5, 0.0, True),
               lambda: flash_reference(q, k, v, kl, d**-0.5, 0.0, True),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=d**-0.5, enable_gqa=True),
               4 * H * d * pairs, 2 * b * H * L * d * 2 + 2 * KVH * sum(lens) * d * 2 + b * H * L * 4, valid,
               grid=fwd_grid(b, H, L, L, d), phase={"1.5b": "stage3-sft", "7b tp2 shard": None}.get(label, ""))
        del q, k, v, mask

    # K2 at the ring block shape: one rank's 2,048-token chunk of a 16,384-token prompt split over 8 ranks
    # ([ring-prefill] runs them): the diagonal block, causal, and a block below it, full; the ring takes
    # K2's fp32 partials (unnormalised output, max, denominator), held to the plain version's
    b, H, KVH, L, d = 1, 28, 4, 2048, 128
    if forward_splits(b, H, L, L, d=d) != 1:
        raise AssertionError("the ring block's K2 was to run unsplit")
    q, k, v = rn(b, H, L, d), rn(b, KVH, L, d), rn(b, KVH, L, d)
    for label, causal in (("causal", True), ("full", False)):
        pairs = L * (L + 1) // 2 if causal else L * L
        record(f"flash_forward_partials[ring block {label}]", "K2",
               lambda: flash_forward_partials(q, k, v, None, d**-0.5, 0.0, causal),
               lambda: flash_partials_reference(q, k, v, None, d**-0.5, 0.0, causal),
               lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=d**-0.5, enable_gqa=True),
               4 * H * d * pairs, b * H * L * d * (2 + 4) + 2 * b * KVH * L * d * 2 + 2 * b * H * L * 4, outputs=3,
               grid=fwd_grid(b, H, L, L, d), phase="ring-prefill")
    del q, k, v

    # K2 global compressor: 9 heads, 32 queries over 32 x 27 x 27 = 23,328 keys, d = 128, split
    # over the keys; b 1 serves one request, b 2 the batched request and the train step
    H, Lq, Lk, d = 9, 32, 23328, 128
    for b in (1, 2):
        q, k, v = rn(b, H, Lq, d), rn(b, H, Lk, d), rn(b, H, Lk, d)
        record(f"flash_forward[global 32f b{b}]", "K2",
               lambda: flash_forward(q, k, v, None, d**-0.5, 0.0, False),
               lambda: flash_reference(q, k, v, None, d**-0.5, 0.0, False),
               lambda: F.scaled_dot_product_attention(q, k, v, scale=d**-0.5),
               4 * b * H * Lq * Lk * d, 2 * b * H * Lq * d * 2 + 2 * b * H * Lk * d * 2 + b * H * Lq * 4,
               outputs=2, grid=fwd_grid(b, H, Lq, Lk, d))
        if b * H * fwd_grid(b, H, Lq, Lk, d)[2] < sms:
            raise AssertionError(f"the global compressor's forward at b {b} does not fill the card")
        del q, k, v

    # K2 with forced splits at a small masked shape: uneven chunks, chunks wholly past
    # kv_lengths (b 0 has 2 key tiles), and a causal one whose last chunk is all masked for
    # some rows of a query block
    for label, (b, H, KVH, Lq, Lk, d, causal, lens) in (
            ("lengths", (2, 4, 4, 37, 130, 32, False, [100, 130])),
            ("causal", (2, 4, 2, 300, 300, 64, True, [217, 300]))):
        q, k, v = rn(b, H, Lq, d), rn(b, KVH, Lk, d), rn(b, KVH, Lk, d)
        kl = torch.tensor(lens, device=dev, dtype=torch.int32)
        pos = torch.arange(max(Lq, Lk))
        pairs = sum(int(((pos[None, :Lk] < n) & ((pos[None, :Lk] <= pos[:Lq, None] + Lk - Lq) | (not causal)))
                        .sum()) for n in lens)
        for n_split in (1, 2, 3, 7):
            record(f"flash_forward[{label} split {n_split}]", "K2",
                   lambda: _launch(q, k, v, kl, d**-0.5, 0.1, causal, n_split=n_split),
                   lambda: flash_reference(q, k, v, kl, d**-0.5, 0.1, causal), None,
                   4 * H * d * pairs, 2 * b * H * Lq * d * 2 + 2 * KVH * sum(lens) * d * 2 + b * H * Lq * 4,
                   outputs=2, grid=fwd_grid(b, H, Lq, Lk, d, n_split), phase=None)
        del q, k, v
    split_pass_checks(rn, record)

    # K3: decode over a 4096-slot cache, ragged bitmaps (a padded prompt's pad slots are
    # invalid): b 1 (the single request; its valid slots end inside a 32-slot chunk) and
    # b 2 (the batched request), bf16 cache; b 2 also with an int8 cache + scales
    b, H, KVH, S, d = 2, 28, 4, 4096, 128
    slot = torch.arange(S, device=dev)
    bitmap = torch.stack([slot < 760, (slot < 700) | ((slot >= 743) & (slot < 760))])
    n_valid = int(bitmap.sum())
    q = rn(b, H, 1, d)
    kb, vb = rn(b, KVH, S, d), rn(b, KVH, S, d)
    for label, rows in (("b1", slice(0, 1)), ("b2", slice(0, 2))):
        qr, kr, vr, mr = q[rows], kb[rows], vb[rows], bitmap[rows]
        nv, br = int(mr.sum()), mr.shape[0]
        record(f"flash_decode[bf16 cache {label}]", "K3",
               lambda: flash_decode(qr, kr, vr, mr),
               lambda: decode_reference(qr, kr, vr, mr, None, None, d**-0.5),
               lambda: F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mr[:, None, None, :], enable_gqa=True),
               4 * H * d * nv, 2 * br * H * d * 2 + nv * KVH * d * 2 * 2 + br * S,
               grid=(-(-S // DECODE_CHUNK), br * KVH))
    # the serving engine's shape: 4 slots at other offsets, each valid up to its
    # true prompt length, then from its spliced (bucket-padded) length to its
    # offset: rows of (true prompt, spliced prompt, tokens generated)
    eng_rows = ((729, 743, 20), (735, 743, 5), (40, 64, 30), (721, 807, 12))
    emask = torch.stack([(slot < t) | ((slot >= sp) & (slot <= sp + g)) for t, sp, g in eng_rows])
    ne = int(emask.sum())
    # the whole heads, and a tp-2 rank's 14 / 2 of them (a check only: [mesh-serve] runs tp 1 on one card)
    for label, He, KVHe, phase in (("engine b4", H, KVH, "serve-engine"), ("engine b4 tp2 shard", 14, 2, None)):
        qe, ke, ve = rn(4, He, 1, d), rn(4, KVHe, S, d), rn(4, KVHe, S, d)
        record(f"flash_decode[{label}]", "K3", lambda: flash_decode(qe, ke, ve, emask),
               lambda: decode_reference(qe, ke, ve, emask, None, None, d**-0.5),
               lambda: F.scaled_dot_product_attention(qe, ke, ve, attn_mask=emask[:, None, None, :], enable_gqa=True),
               4 * He * d * ne, 2 * 4 * He * d * 2 + ne * KVHe * d * 2 * 2 + 4 * S,
               grid=(-(-S // DECODE_CHUNK), 4 * KVHe), phase=phase)
        del qe, ke, ve
    ki = torch.randint(-127, 128, (b, KVH, S, d), generator=gen, device=dev, dtype=torch.int8)
    vi = torch.randint(-127, 128, (b, KVH, S, d), generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand(b, KVH, S, generator=gen, device=dev) * 0.02
    vs = torch.rand(b, KVH, S, generator=gen, device=dev) * 0.02
    record("flash_decode[int8 cache]", "K3",  # the main path's cache is bf16
           lambda: flash_decode(q, ki, vi, bitmap, k_scale=ks, v_scale=vs),
           lambda: decode_reference(q, ki, vi, bitmap, ks, vs, d**-0.5), None,
           4 * H * d * n_valid, 2 * b * H * d * 2 + n_valid * KVH * (d * 2 + 8) + b * S, phase=None)
    # a row whose bitmap has no valid slot: the uniform average of its values (the
    # TPU kernel's and the twin's answer), each row held to the twin on its own
    clear = bitmap.clone()
    clear[1] = False
    for label, kk, vv, kss, vss in (("bf16", kb, vb, None, None), ("int8", ki, vi, ks, vs)):
        got = flash_decode(q, kk, vv, clear, k_scale=kss, v_scale=vss)
        ref = decode_reference(q, kk, vv, clear, kss, vss, d**-0.5)
        ratios = [agreement(got[r], ref[r])[1] for r in (0, 1)]
        log(f"[kernel] flash_decode[{label} cache, all-clear row]: worst err/tol {ratios[0]:.3f} (normal row), "
            f"{ratios[1]:.3f} (all-clear row, ref rms {agreement(ref[1], ref[1])[2]:.3g})")
        if not max(ratios) <= 1:
            raise AssertionError(f"flash_decode disagrees with its twin on an all-clear row ({label})")
    del kb, vb, ki, vi

    # K3 at the other widths it takes (head dim 64 or 128, groups 1-8): Qwen2.5-0.5B's 14 / 2 heads of 64 at
    # [baseline-0.5b]'s fill (b 1: the 8-frame request's spliced prompt and 8 of its 16 new tokens), with a bf16
    # cache and (a check only) an int8 one; group 5 (Qwen2.5-14B/32B's 40 / 8 heads) and group 3 (12 / 4) at
    # the 7B rows' 760 valid slots, checks only. The library call is SDPA with enable_gqa and the slot mask as
    # an additive bf16 mask (0 / -inf); for the int8 cache over its dequantized bf16 copy, made beforehand.
    for label, Hn, KVHn, dn, fill, quant, phase in (
            ("0.5b d64 b1", 14, 2, 64, BASELINE_PREFILL[0] + 8, False, "baseline-0.5b"),
            ("0.5b d64 b1 int8 cache", 14, 2, 64, BASELINE_PREFILL[0] + 8, True, None),
            ("g5 40/8 b1", 40, 8, 128, 760, False, None),
            ("g3 12/4 b1", 12, 4, 128, 760, False, None)):
        mn = (slot < fill)[None]
        qn = rn(1, Hn, 1, dn)
        if quant:
            kn, vn = (torch.randint(-127, 128, (1, KVHn, S, dn), generator=gen, device=dev, dtype=torch.int8)
                      for _ in range(2))
            ksn, vsn = (torch.rand(1, KVHn, S, generator=gen, device=dev) * 0.02 for _ in range(2))
            lib_k, lib_v = kn.to(torch.bfloat16) * ksn[..., None].to(torch.bfloat16), \
                vn.to(torch.bfloat16) * vsn[..., None].to(torch.bfloat16)
            row_bytes = dn * 2 + 8
        else:
            kn, vn, ksn, vsn = rn(1, KVHn, S, dn), rn(1, KVHn, S, dn), None, None
            lib_k, lib_v, row_bytes = kn, vn, dn * 2 * 2
        additive = torch.zeros(1, 1, 1, S, device=dev, dtype=torch.bfloat16).masked_fill(~mn[:, None, None, :],
                                                                                         float("-inf"))
        record(f"flash_decode[{label}]", "K3", lambda: flash_decode(qn, kn, vn, mn, k_scale=ksn, v_scale=vsn),
               lambda: decode_reference(qn, kn, vn, mn, ksn, vsn, dn**-0.5),
               lambda: F.scaled_dot_product_attention(qn, lib_k, lib_v, attn_mask=additive, enable_gqa=True),
               4 * Hn * dn * fill, 2 * Hn * dn * 2 + fill * KVHn * row_bytes + S,
               grid=(-(-S // DECODE_CHUNK), KVHn), phase=phase)
        del qn, kn, vn, lib_k, lib_v

    # K2 at [baseline-0.5b]'s prefill: the batch of 2 (prompts of 64 and 41 ids, each with 162 visual
    # tokens spliced in) over Qwen2.5-0.5B's 14 / 2 heads of 64, causal, right-padded
    b, H, KVH, d = 2, 14, 2, 64
    L, lens = BASELINE_PREFILL[0], list(BASELINE_PREFILL)
    q, k, v = rn(b, H, L, d), rn(b, KVH, L, d), rn(b, KVH, L, d)
    kl = torch.tensor(lens, device=dev, dtype=torch.int32)
    pos = torch.arange(L, device=dev)
    mask = (pos[None, :] <= pos[:, None])[None, None] & (pos[None, None, None, :] < kl[:, None, None, None])
    valid = (pos[None, :] < kl[:, None])[:, None, :].expand(b, H, L)
    pairs = sum(int(np.minimum(n, np.arange(L) + 1).sum()) for n in lens)
    record("flash_forward[prefill 0.5b]", "K2",
           lambda: flash_forward(q, k, v, kl, d**-0.5, 0.0, True),
           lambda: flash_reference(q, k, v, kl, d**-0.5, 0.0, True),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=d**-0.5, enable_gqa=True),
           4 * H * d * pairs, 2 * b * H * L * d * 2 + 2 * KVH * sum(lens) * d * 2 + b * H * L * 4, valid,
           grid=fwd_grid(b, H, L, L, d), phase="baseline-0.5b")
    del q, k, v, mask

    # K4: local compressor, key/value (32 b, 27, 27, 1152), one query per 4x3x3 tile, in the main path's call
    # form (Python-float scale, bias 0.0: both pass by value); b 1 serves one request, b 2 the batched one (the
    # batch folds into the frame axis). The library call is SDPA over the tile-grouped view, the grouping copy of
    # key and value (tile_thw) included. Then the clip-scale form (exp of a bf16 logit_scale and a bf16 bias,
    # read on the card), whose uniform bias SDPA may leave out (it cancels in the softmax), and the image tile
    # (1, 3, 3) at t = 1, checked and not timed.
    c = 1152
    for b in (1, 2):
        t, h, w = 32 * b, 27, 27
        key, val, qq = rn(t, h, w, c), rn(t, h, w, c), rn(t // 4, h // 3, w // 3, c)
        n_tiles = (t // 4) * (h // 3) * (w // 3)
        record(f"fused_tile_attention[local 32f b{b}]", "K4",
               lambda: fused_tile_attention(qq, key, val, (4, 3, 3), c**-0.5, 0.0),
               lambda: tile_reference(qq, key, val, (4, 3, 3), c**-0.5, 0.0),
               lambda: F.scaled_dot_product_attention(qq.reshape(n_tiles, 1, 1, c), tile_thw(key, (4, 3, 3))[:, None],
                                                      tile_thw(val, (4, 3, 3))[:, None], scale=c**-0.5),
               4 * n_tiles * 36 * c, 2 * t * h * w * c * 2 + 2 * n_tiles * c * 2, grid=(min(n_tiles, sms),))
        if b == 1:
            logit_scale = torch.tensor(-3.0, device=dev, dtype=torch.bfloat16)
            logit_bias = torch.tensor(0.4, device=dev, dtype=torch.bfloat16)
            clip_scale = float(torch.exp(logit_scale))
            record("fused_tile_attention[local 32f b1 clip-scale]", "K4",
                   lambda: fused_tile_attention(qq, key, val, (4, 3, 3), torch.exp(logit_scale), logit_bias),
                   lambda: tile_reference(qq, key, val, (4, 3, 3), torch.exp(logit_scale), logit_bias),
                   lambda: F.scaled_dot_product_attention(qq.reshape(n_tiles, 1, 1, c),
                                                          tile_thw(key, (4, 3, 3))[:, None],
                                                          tile_thw(val, (4, 3, 3))[:, None], scale=clip_scale),
                   4 * n_tiles * 36 * c, 2 * t * h * w * c * 2 + 2 * n_tiles * c * 2, grid=(min(n_tiles, sms),),
                   phase=None)  # the 7B serving config has no clip scale
        del key, val, qq
    # the image tile: [baseline-0.5b]'s single-image request (one 27 x 27 frame, tiles of 1 x 3 x 3)
    key, val, qq = rn(1, 27, 27, c), rn(1, 27, 27, c), rn(1, 9, 9, c)
    record("fused_tile_attention[image 1x27x27, tile 1x3x3]", "K4",
           lambda: fused_tile_attention(qq, key, val, (1, 3, 3), c**-0.5, 0.0),
           lambda: tile_reference(qq, key, val, (1, 3, 3), c**-0.5, 0.0),
           lambda: F.scaled_dot_product_attention(qq.reshape(81, 1, 1, c), tile_thw(key, (1, 3, 3))[:, None],
                                                  tile_thw(val, (1, 3, 3))[:, None], scale=c**-0.5),
           4 * 81 * 9 * c, 2 * 27 * 27 * c * 2 + 2 * 81 * c * 2, grid=(min(81, sms),), phase="baseline-0.5b-image")
    del key, val, qq
    fp32_checks(record, fwd_grid, sms)
    anyres_clip_checks(rn, record, fwd_grid, sms)
    backward_checks(rn, record)
    backward_checks(lambda *shape: torch.randn(*shape, generator=gen, device=dev), record, fp32=True)
    new_width_backward_checks(record)
    head_dim_checks(record, fwd_grid, sms, UP_TO_256)
    head_dim_checks(record, fwd_grid, sms, PAST_256)
    return {name: r for name, r in records.items() if r[1] is not None}


def fp32_checks(record, fwd_grid, sms):
    """Phase 3, the fp32 instances (``csrc/flash_fwd_f32.cu``, the merge's and
    K4's fp32 forms) at the shapes of [fp32-serve], each against its fp32 plain
    version on the card (TF32 off) at ``FP32_GATE``, its bound at the fp32
    peak (no tensor core takes fp32 operands), the library call SDPA in fp32:
    K1 over the tower's 512 rows of 729, d 72; K2 at the 7B prefill (b 2,
    28 / 4 heads, 743 tokens, causal, lengths 743 / 700) and at the global
    compressor's b 1 (split, then the fp32 merge; the merge alone too); K4 on
    the b 1 volume. Then checks only: K1 and K2 at head dims 16 and 96 in bf16
    and fp32 (K2 causal with lengths, K2 at d 96 grouped too), and the
    clip-scale form of K4 in fp32."""
    import torch
    import torch.nn.functional as F

    from hicom_tpu_torch.ops.flash_attention import (_launch_merge, flash_forward, flash_reference,
                                                     fullblock_attention, merge_partials_reference)
    from hicom_tpu_torch.ops.grouping import tile_thw
    from hicom_tpu_torch.ops.local_attn import fused_tile_attention, tile_reference

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("the fp32 plain versions would run on TF32")
    gen = torch.Generator("cuda").manual_seed(17)
    f32 = dict(gate=FP32_GATE, flops_rate=FP32_PEAK)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    bh, L, d = 512, 729, 72
    q, k, v = rn(bh, L, d), rn(bh, L, d), rn(bh, L, d)
    record("fullblock_attention[siglip 32f fp32]", "K1-f32", lambda: fullblock_attention(q, k, v, d**-0.5),
           lambda: flash_reference(q[:, None], k[:, None], v[:, None], None, d**-0.5, 0.0, False)[0][:, 0],
           lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], scale=d**-0.5),
           4 * bh * L * L * d, 4 * bh * L * d * 4 + bh * L * 4, grid=fwd_grid(bh, 1, L, L, d, fp32=True),
           phase="fp32-serve", **f32)
    del q, k, v

    b, H, KVH, L, d, lens = 2, 28, 4, 743, 128, [743, 700]
    q, k, v = rn(b, H, L, d), rn(b, KVH, L, d), rn(b, KVH, L, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32)
    pos = torch.arange(L, device="cuda")
    mask = (pos[None, :] <= pos[:, None])[None, None] & (pos[None, None, None, :] < kl[:, None, None, None])
    valid = (pos[None, :] < kl[:, None])[:, None, :].expand(b, H, L)
    pairs = sum(int(np.minimum(n, np.arange(L) + 1).sum()) for n in lens)
    record("flash_forward[prefill 7b fp32]", "K2-f32", lambda: flash_forward(q, k, v, kl, d**-0.5, 0.0, True),
           lambda: flash_reference(q, k, v, kl, d**-0.5, 0.0, True),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=d**-0.5, enable_gqa=True),
           4 * H * d * pairs, 2 * b * H * L * d * 4 + 2 * KVH * sum(lens) * d * 4 + b * H * L * 4, valid,
           grid=fwd_grid(b, H, L, L, d, fp32=True), phase="fp32-serve", **f32)
    del q, k, v, mask

    H, Lq, Lk, d = 9, 32, 23328, 128
    q, k, v = rn(1, H, Lq, d), rn(1, H, Lk, d), rn(1, H, Lk, d)
    grid = fwd_grid(1, H, Lq, Lk, d, fp32=True)
    record("flash_forward[global 32f b1 fp32]", "K2-f32", lambda: flash_forward(q, k, v, None, d**-0.5, 0.0, False),
           lambda: flash_reference(q, k, v, None, d**-0.5, 0.0, False),
           lambda: F.scaled_dot_product_attention(q, k, v, scale=d**-0.5),
           4 * H * Lq * Lk * d, 2 * H * Lq * d * 4 + 2 * H * Lk * d * 4 + H * Lq * 4, outputs=2,
           grid=grid, phase="fp32-serve", **f32)
    if grid[2] < 2:
        raise AssertionError("the global compressor's fp32 forward was to run split")
    del q, k, v
    n, rows, d = grid[2], 9 * 32, 128
    o = rn(n, rows, d) * 50
    m = rn(n, rows) * 3
    m[3], m[7, : rows // 2] = -1e30, float("-inf")
    l = torch.rand(n, rows, generator=gen, device="cuda") * 50 + 1
    record(f"flash_merge[global 32f b1 fp32, {n} chunks]", "K2-merge", lambda: _launch_merge(o, m, l, torch.float32),
           lambda: merge_partials_reference(o, m, l, torch.float32), None,
           4 * n * rows * d, n * rows * (d + 2) * 4 + rows * (d + 1) * 4, outputs=2, grid=(-(-rows // 4),),
           phase="fp32-serve", **f32)
    del o, m, l

    c, t, h, w = 1152, 32, 27, 27
    key, val, qq = rn(t, h, w, c), rn(t, h, w, c), rn(t // 4, h // 3, w // 3, c)
    n_tiles = (t // 4) * (h // 3) * (w // 3)
    record("fused_tile_attention[local 32f b1 fp32]", "K4",
           lambda: fused_tile_attention(qq, key, val, (4, 3, 3), c**-0.5, 0.0),
           lambda: tile_reference(qq, key, val, (4, 3, 3), c**-0.5, 0.0),
           lambda: F.scaled_dot_product_attention(qq.reshape(n_tiles, 1, 1, c), tile_thw(key, (4, 3, 3))[:, None],
                                                  tile_thw(val, (4, 3, 3))[:, None], scale=c**-0.5),
           4 * n_tiles * 36 * c, 2 * t * h * w * c * 4 + 2 * n_tiles * c * 4, grid=(min(n_tiles, sms),),
           phase="fp32-serve", **f32)
    scale, bias = torch.exp(torch.tensor(-3.0, device="cuda")), torch.tensor(0.4, device="cuda")
    record("fused_tile_attention[local 32f b1 fp32 clip-scale]", "K4",
           lambda: fused_tile_attention(qq, key, val, (4, 3, 3), scale, bias),
           lambda: tile_reference(qq, key, val, (4, 3, 3), scale, bias), None,
           4 * n_tiles * 36 * c, 2 * t * h * w * c * 4 + 2 * n_tiles * c * 4, phase=None, **f32)
    del key, val, qq

    # head dims 16 and 96 (the selftest's decoder, a non-grouped decoder of 96): checks only, no phase runs them
    for dtype, kw, tag in ((torch.bfloat16, dict(gate=BF16_GATE), "bf16"), (torch.float32, f32, "fp32")):
        item, fp32 = (2, False) if dtype == torch.bfloat16 else (4, True)
        f = "" if dtype == torch.bfloat16 else "-f32"
        for d in (16, 96):
            bh, L = 64, 729
            q, k, v = rn(bh, L, d, dtype=dtype), rn(bh, L, d, dtype=dtype), rn(bh, L, d, dtype=dtype)
            # SDPA leaves the uniform bias out: it cancels in the softmax
            record(f"fullblock_attention[d{d} {tag}]", f"K1{f}", lambda: fullblock_attention(q, k, v, d**-0.5, 0.1),
                   lambda: flash_reference(q[:, None], k[:, None], v[:, None], None, d**-0.5, 0.1, False)[0][:, 0],
                   lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], scale=d**-0.5),
                   4 * bh * L * L * d, 4 * bh * L * d * item + bh * L * 4,
                   grid=fwd_grid(bh, 1, L, L, d, fp32=fp32), phase=None, **kw)
            for H, KVH in ((8, 8), (8, 2)):
                b, L, lens = 2, 600, [600, 517]
                q, k, v = rn(b, H, L, d, dtype=dtype), rn(b, KVH, L, d, dtype=dtype), rn(b, KVH, L, d, dtype=dtype)
                kl = torch.tensor(lens, device="cuda", dtype=torch.int32)
                pos = torch.arange(L, device="cuda")
                valid = (pos[None, :] < kl[:, None])[:, None, :].expand(b, H, L)
                mask = (pos[None, :] <= pos[:, None])[None, None] & (pos[None, None, None, :] < kl[:, None, None, None])
                pairs = sum(int(np.minimum(n, np.arange(L) + 1).sum()) for n in lens)
                record(f"flash_forward[d{d} {H}/{KVH} causal lengths {tag}]", f"K2{f}",
                       lambda: flash_forward(q, k, v, kl, d**-0.5, 0.0, True),
                       lambda: flash_reference(q, k, v, kl, d**-0.5, 0.0, True),
                       lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=d**-0.5,
                                                              enable_gqa=True),
                       4 * H * d * pairs, 2 * b * H * L * d * item + 2 * KVH * sum(lens) * d * item + b * H * L * 4,
                       valid, grid=fwd_grid(b, H, L, L, d, fp32=fp32), phase=None, **kw)
                del mask
            del q, k, v


def anyres_prefill_shape():
    """(spliced length, valid length) of the [anyres] request of the 1920x1080
    image: mm_infer pads the prompt to 64 ids, the splice adds 7,270 - 1."""
    n = anyres_prompt(WordTokenizer(152064)).shape[1]
    return 64 - 1 + ANYRES_TOKENS[0], n - 1 + ANYRES_TOKENS[0]


def exact_prefill(q, k, v, kl):
    """The float64 plain version of a causal prefill, (b, H, L, d), one KV
    head's group at a time (all 28 heads' float64 scores over 7,333 tokens
    would take 12 GB a tensor)."""
    import torch

    from hicom_tpu_torch.ops.flash_attention import flash_reference

    g = q.shape[1] // k.shape[1]
    return torch.cat([flash_reference(q[:, j * g:(j + 1) * g].double(), k[:, j:j + 1].double(),
                                      v[:, j:j + 1].double(), kl, q.shape[-1]**-0.5, 0.0, True)[0]
                      for j in range(k.shape[1])], dim=1)


def anyres_clip_checks(rn, record, fwd_grid, sms):
    """Phase 3 at the shapes of [clip] and [anyres]: K1 over CLIP's 577
    tokens at d 64 (32 frames x 16 heads) and so400m over an anyres image's
    16 crops; K2 on the anyres prefill (b 1, 28/4 heads, 7,333 tokens, causal,
    its valid length) and the CLIP global compressor (8 heads, 32 queries
    over 32 x 24 x 24 keys); K3 over the 8,192-slot cache of that prefill; K4
    on CLIP's grid (qk 768, dv 1024); and, a check only, K4 on the anyres
    patch grid (1, 60, 108) that the HICom projector would take."""
    import torch
    import torch.nn.functional as F

    from hicom_tpu_torch.ops.flash_attention import flash_forward, flash_reference, fullblock_attention
    from hicom_tpu_torch.ops.flash_decode import DECODE_CHUNK, decode_reference, flash_decode
    from hicom_tpu_torch.ops.grouping import tile_thw
    from hicom_tpu_torch.ops.local_attn import fused_tile_attention, tile_reference

    dev = "cuda"
    for label, bh, L, d, phase in (("clip 32f", 32 * 16, 577, 64, "clip"), ("siglip anyres 16 crops", 16 * 16, 729,
                                                                            72, "anyres")):
        q, k, v = rn(bh, L, d), rn(bh, L, d), rn(bh, L, d)
        record(f"fullblock_attention[{label}]", "K1", lambda: fullblock_attention(q, k, v, d**-0.5),
               lambda: flash_reference(q[:, None], k[:, None], v[:, None], None, d**-0.5, 0.0, False)[0][:, 0],
               lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], scale=d**-0.5),
               4 * bh * L * L * d, 4 * bh * L * d * 2 + bh * L * 4, grid=fwd_grid(bh, 1, L, L, d), phase=phase)
        del q, k, v

    # K2 anyres prefill: one right-padded row (mm_infer's 64-id bucket)
    L, n = anyres_prefill_shape()
    H, KVH, d = 28, 4, 128
    q, k, v = rn(1, H, L, d), rn(1, KVH, L, d), rn(1, KVH, L, d)
    kl = torch.tensor([n], device=dev, dtype=torch.int32)
    pos = torch.arange(L, device=dev)
    mask = ((pos[None, :] <= pos[:, None]) & (pos[None, :] < n))[None, None]
    valid = (pos < n)[None, None, :].expand(1, H, L)
    pairs = int(np.minimum(n, np.arange(L) + 1).sum())
    record("flash_forward[prefill anyres 7b]", "K2", lambda: flash_forward(q, k, v, kl, d**-0.5, 0.0, True),
           lambda: flash_reference(q, k, v, kl, d**-0.5, 0.0, True),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=d**-0.5, enable_gqa=True),
           4 * H * d * pairs, 2 * H * L * d * 2 + 2 * KVH * n * d * 2 + H * L * 4, valid, grid=fwd_grid(1, H, L, L, d),
           phase="anyres", exact_fn=lambda: exact_prefill(q, k, v, kl))
    del q, k, v, mask

    # K2 CLIP global compressor: 1024 / 128 = 8 heads, 32 queries over 32 x 24 x 24 keys
    H, Lq, Lk = 8, 32, 32 * 24 * 24
    q, k, v = rn(1, H, Lq, d), rn(1, H, Lk, d), rn(1, H, Lk, d)
    record("flash_forward[global clip 32f b1]", "K2", lambda: flash_forward(q, k, v, None, d**-0.5, 0.0, False),
           lambda: flash_reference(q, k, v, None, d**-0.5, 0.0, False),
           lambda: F.scaled_dot_product_attention(q, k, v, scale=d**-0.5),
           4 * H * Lq * Lk * d, 2 * H * Lq * d * 2 + 2 * H * Lk * d * 2 + H * Lq * 4, outputs=2,
           grid=fwd_grid(1, H, Lq, Lk, d), phase="clip")
    del q, k, v

    # K3 over the anyres request's 8,192-slot cache, midway through its decode: the prompt's
    # valid slots, its padding, then 8 generated tokens
    S, H, KVH = 8192, 28, 4
    slot = torch.arange(S, device=dev)
    bitmap = ((slot < n) | ((slot >= L) & (slot < L + 8)))[None]
    nv = int(bitmap.sum())
    q, kc, vc = rn(1, H, 1, d), rn(1, KVH, S, d), rn(1, KVH, S, d)
    record("flash_decode[bf16 cache 8192 anyres]", "K3", lambda: flash_decode(q, kc, vc, bitmap),
           lambda: decode_reference(q, kc, vc, bitmap, None, None, d**-0.5),
           lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=bitmap[:, None, None, :], enable_gqa=True),
           4 * H * d * nv, 2 * H * d * 2 + nv * KVH * d * 2 * 2 + S, grid=(-(-S // DECODE_CHUNK), KVH),
           phase="anyres")
    del q, kc, vc

    # K4 on CLIP's grid: keys the 768-wide visual_projection embeds, values the 1024-wide features
    (t, h, w), tile, qk, dv = (32, 24, 24), (4, 3, 3), 768, 1024
    key, val, qq = rn(t, h, w, qk), rn(t, h, w, dv), rn(t // 4, h // 3, w // 3, qk)
    n_tiles = (t // 4) * (h // 3) * (w // 3)
    record("fused_tile_attention[local clip 32f b1]", "K4",
           lambda: fused_tile_attention(qq, key, val, tile, qk**-0.5, 0.0),
           lambda: tile_reference(qq, key, val, tile, qk**-0.5, 0.0),
           lambda: F.scaled_dot_product_attention(qq.reshape(n_tiles, 1, 1, qk), tile_thw(key, tile)[:, None],
                                                  tile_thw(val, tile)[:, None], scale=qk**-0.5),
           4 * n_tiles * 36 * (qk + dv) // 2, t * h * w * (qk + dv) * 2 + n_tiles * (qk + dv) * 2,
           grid=(min(n_tiles, sms),), phase="clip")
    del key, val, qq
    # K4 on an anyres patch grid (tile 1x3x3): the HICom projector's dict path, which no phase runs
    key, val, qq = rn(1, 60, 108, 1152), rn(1, 60, 108, 1152), rn(1, 20, 36, 1152)
    record("fused_tile_attention[anyres patch 60x108]", "K4",
           lambda: fused_tile_attention(qq, key, val, (1, 3, 3), 1152**-0.5, 0.0),
           lambda: tile_reference(qq, key, val, (1, 3, 3), 1152**-0.5, 0.0), None,
           4 * 720 * 9 * 1152, 2 * 60 * 108 * 1152 * 2 + 2 * 720 * 1152 * 2, grid=(min(720, sms),), phase=None)
    del key, val, qq


def split_pass_checks(rn, record):
    """Phase 3, the split path's second passes alone, at the global
    compressor's shapes: the forward's merge of 29 chunk partials (b 1) with
    chunks that walked no tile (max -inf) and chunks all masked for their rows
    (max -1e30); and the merge kernel
    through its own wrapper ``merge_partials`` at the 8-rank ring's shape, the
    last rank's 8 block partials of 28 heads x 2,048 rows, half the blocks
    with no valid key for a quarter of the rows (max -1e30)."""
    import torch

    from hicom_tpu_torch.ops.flash_attention import _launch_merge, merge_partials, merge_partials_reference

    gen = torch.Generator("cuda").manual_seed(2)
    n, rows, d = 29, 9 * 32, 128
    o = torch.randn(n, rows, d, generator=gen, device="cuda") * 50
    m = torch.randn(n, rows, generator=gen, device="cuda") * 3
    m[3], m[7, : rows // 2] = -1e30, float("-inf")
    l = torch.rand(n, rows, generator=gen, device="cuda") * 50 + 1
    record("flash_merge[global 32f b1, 29 chunks]", "K2-merge", lambda: _launch_merge(o, m, l),
           lambda: merge_partials_reference(o, m, l, torch.bfloat16), None,
           4 * n * rows * d, n * rows * (d + 2) * 4 + rows * (d * 2 + 4), outputs=2, grid=(-(-rows // 4),),
           flops_rate=FP32_PEAK)
    n, rows, d = 8, 28 * 2048, 128
    o = torch.randn(n, rows, d, generator=gen, device="cuda") * 50
    m = torch.randn(n, rows, generator=gen, device="cuda") * 3
    m[4:, : rows // 4] = -1e30  # blocks with no valid key for these rows
    l = torch.rand(n, rows, generator=gen, device="cuda") * 2048 + 1
    record("merge_partials[ring 8 ranks, 28 x 2048 rows]", "K2-merge-ranks",
           lambda: merge_partials(o, m, l, torch.bfloat16), lambda: merge_partials_reference(o, m, l, torch.bfloat16),
           None, 4 * n * rows * d, n * rows * (d + 2) * 4 + rows * (d * 2 + 4), outputs=2, grid=(-(-rows // 4),),
           flops_rate=FP32_PEAK, phase="ring-prefill")
    del o, m, l


def backward_checks(rn, record, fp32: bool = False):
    """Phase 3, flash backward: K5 (dQ) and K6 (dK, dV) at the three shapes the
    train steps give them (the 7B and 1.5B decoders, the global compressor) and
    at the tower's, which no phase runs yet (a check only), each held to the
    plain twin; the library call is the
    backward of ``F.scaled_dot_product_attention`` at the same shape (dQ, dK and
    dV together), through ``torch.autograd.grad`` on a kept graph. At the
    decoder shape K6 also runs with forced splits of 1, 2 and 7 (the default is
    3), and its sum pass alone on two seeded fp32 workspaces; at the global
    compressor's shape K5's sum pass alone over its 14 chunks. With ``fp32``
    (``rn`` draws fp32): the same at [fp32-train]'s shapes, the 7B decoder and
    the global compressor at b 2, through the fp32 instances
    (``csrc/flash_bwd_f32.cu``, the sum pass writing fp32), within
    ``FP32_GATE`` (TF32 off), bounds at the fp32 peak."""
    import torch
    import torch.nn.functional as F

    from hicom_tpu_torch.ops.flash_attention import (DKV_BLOCK_K, _launch_dkv, _launch_dq, _launch_part_sum,
                                                     backward_operands, dkv_splits, dq_block_q, dq_splits,
                                                     flash_backward_reference, flash_forward, fullblock_attention,
                                                     sum_partials_reference)

    dev = "cuda"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [  # label, b, H, KVH, Lq, Lk, d, causal, kv lengths, the phase that runs the shape
        ("prefill 7b", 2, 28, 4, 743, 743, 128, True, [743, 700], "train"),  # decoder, right-padded row
        ("prefill 1.5b", 2, 12, 2, 743, 743, 128, True, [743, 700], "stage3-sft"),  # the 1.5B decoder
        ("global 32f b2", 2, 9, 9, 32, 23328, 128, False, None, "train"),  # global compressor
        ("siglip 32f", 512, 1, 1, 729, 729, 72, False, None, None),  # tower rows (K1's route): no phase
        ("prefill anyres 7b", 2, 28, 4) + anyres_prefill_shape()[:1] * 2 + (  # 2 rows of the 1920x1080 plan
            128, True, [anyres_prefill_shape()[0], 41 - 1 + ANYRES_TOKENS[0]], "anyres-train"),
    ]
    item, dtype, f, gate = 2, torch.bfloat16, "", BF16_GATE
    if fp32:
        shapes = [(f"{x[0]} fp32",) + x[1:-1] + ("fp32-train",) for x in shapes if x[0] in ("prefill 7b", "global 32f b2")]
        item, dtype, f, gate = 4, torch.float32, "-f32", FP32_GATE
    kw = dict(gate=gate, flops_rate=FP32_PEAK) if fp32 else {}
    for label, b, H, KVH, Lq, Lk, d, causal, lens, phase in shapes:
        q, k, v, do = rn(b, H, Lq, d), rn(b, KVH, Lk, d), rn(b, KVH, Lk, d), rn(b, H, Lq, d)
        kl = torch.tensor(lens, device=dev, dtype=torch.int32) if lens else None
        scale = d**-0.5
        if KVH == H == 1:  # the tower's rows come from K1
            out, lse = fullblock_attention(q[:, 0], k[:, 0], v[:, 0], scale)
            out, lse = out[:, None], lse[:, None]
        else:
            out, lse = flash_forward(q, k, v, kl, scale, 0.0, causal)
        ops = backward_operands(q, k, v, kl, out, lse, do)

        def plain():
            if b * H * Lq * Lk * 4 <= 2**32:
                return flash_backward_reference(q, k, v, kl, out, lse, do, scale, 0.0, causal)
            # one KV head's group at a time: the twin's fp32 scores of all heads over
            # 7,333 tokens would take 12 GB a tensor
            g = H // KVH
            parts = [flash_backward_reference(q[:, j * g:(j + 1) * g], k[:, j:j + 1], v[:, j:j + 1], kl,
                                              out[:, j * g:(j + 1) * g], lse[:, j * g:(j + 1) * g],
                                              do[:, j * g:(j + 1) * g], scale, 0.0, causal) for j in range(KVH)]
            return tuple(torch.cat(x, dim=1) for x in zip(*parts))

        # the library: SDPA's backward; a boolean mask where there are lengths
        mask = None
        if lens:
            pos = torch.arange(Lk, device=dev)
            mask = (pos[None, None, None, :] < kl[:, None, None, None]) & (
                pos[None, :] <= torch.arange(Lq, device=dev)[:, None] + (Lk - Lq))[None, None]
        lq, lk_, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk_, lv, attn_mask=mask, is_causal=causal and mask is None,
                                                 scale=scale, enable_gqa=H != KVH)
        library = lambda: torch.autograd.grad(lib_out, (lq, lk_, lv), do, retain_graph=True)  # noqa: E731

        # unmasked (q, k) pairs, per head
        rows = np.arange(Lq)
        visible = [np.minimum(n if n is not None else Lk, rows + 1 + (Lk - Lq) if causal else np.full(Lq, Lk))
                   for n in (lens or [None] * b)]
        pairs = int(sum(np.clip(x, 0, None).sum() for x in visible))
        qd_bytes = 2 * b * H * Lq * d * item + 2 * b * H * Lq * 4  # q and dO read, lse and delta read
        kv_bytes = 2 * b * KVH * Lk * d * item  # k and v (read), or dk and dv (written)
        dq_grid = (-(-Lq // dq_block_q(Lq)), b * H, dq_splits(b, H, Lq, Lk, sms, d=d))
        record(f"flash_backward_dq[{label}]", f"K5{f}", lambda: (_launch_dq(*ops, scale, 0.0, causal),), plain,
               library, 6 * H * d * pairs, qd_bytes + kv_bytes + b * H * Lq * d * item, outputs=(0,), grid=dq_grid,
               phase=phase, **kw)
        dkv_grid = (-(-Lk // DKV_BLOCK_K), b * KVH, dkv_splits(b, H, KVH, Lq, Lk, sms, d=d))
        record(f"flash_backward_dkv[{label}]", f"K6{f}", lambda: _launch_dkv(*ops, scale, 0.0, causal), plain,
               library, 8 * H * d * pairs, qd_bytes + 2 * kv_bytes, outputs=(1, 2), grid=dkv_grid, phase=phase, **kw)
        gen = torch.Generator(dev).manual_seed(3)
        if label.startswith("prefill 7b"):
            if int(np.prod(dkv_grid)) < sms:
                raise AssertionError(f"K6's grid {dkv_grid} at the decoder shape does not fill the card")
            for n_split in (1, 2, 7):
                record(f"flash_backward_dkv[{label} split {n_split}]", f"K6{f}",
                       lambda: _launch_dkv(*ops, scale, 0.0, causal, n_split=n_split), plain, None,
                       8 * H * d * pairs, qd_bytes + 2 * kv_bytes, outputs=(1, 2), grid=dkv_grid[:2] + (n_split,),
                       phase=None, **kw)
            n, N = dkv_grid[2], b * KVH * Lk * d
            dk_part, dv_part = (torch.randn(n, N, generator=gen, device=dev) for _ in range(2))
            record(f"flash_dkv_sum[{label}, {n} splits]", "K6-sum",
                   lambda: _launch_part_sum((dk_part, scale), (dv_part, 1.0), dtype=dtype),
                   lambda: (sum_partials_reference(dk_part, scale, dtype),
                            sum_partials_reference(dv_part, 1.0, dtype)), None,
                   2 * n * N, 2 * (n * N * 4 + N * item), outputs=2, grid=(-(-N // 4 // 128), 2),
                   flops_rate=FP32_PEAK, phase=phase, gate=gate)
            del dk_part, dv_part
        if label.startswith("global"):  # K5's 14 chunks summed into dQ
            n, N = dq_grid[2], b * H * Lq * d
            part = torch.randn(n, N, generator=gen, device=dev)
            record(f"flash_dq_sum[{label}, {n} chunks]", "K5-sum",
                   lambda: _launch_part_sum((part, scale), dtype=dtype),
                   lambda: sum_partials_reference(part, scale, dtype), None, n * N, n * N * 4 + N * item,
                   grid=(-(-N // 4 // 128), 1), flops_rate=FP32_PEAK, phase=phase, gate=gate)
            del part
        del q, k, v, do, out, lse, ops, lib_out, lq, lk_, lv, mask
        torch.cuda.empty_cache()


def new_width_backward_checks(record):
    """Phase 3, checks only (no phase trains at these widths): K5/K6 in bf16 at
    the head dims that pad to 16, 48, 96 and 112 (``flash_bwd.cu``'s new
    instances) and in fp32 at 16 and 96, at small masked shapes (causal with
    lengths, grouped at 48 and 112), against the plain twin at each type's gate;
    the library call is SDPA's backward, as in :func:`backward_checks`."""
    import torch
    import torch.nn.functional as F

    from hicom_tpu_torch.ops.flash_attention import (DKV_BLOCK_K, _launch_dkv, _launch_dq, backward_operands,
                                                     dkv_splits, dq_block_q, dq_splits, flash_backward_reference,
                                                     flash_forward)

    gen = torch.Generator("cuda").manual_seed(18)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b, L, lens = 2, 600, [600, 517]
    cases = [(d, torch.bfloat16) for d in (16, 48, 96, 112)] + [(d, torch.float32) for d in (16, 96)]
    for d, dtype in cases:
        H, KVH = (8, 2) if d in (48, 112) else (8, 8)
        item, tag, f = (2, "bf16", "") if dtype == torch.bfloat16 else (4, "fp32", "-f32")
        kw = dict(gate=BF16_GATE) if dtype == torch.bfloat16 else dict(gate=FP32_GATE, flops_rate=FP32_PEAK)
        q, do = (torch.randn(b, H, L, d, generator=gen, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn(b, KVH, L, d, generator=gen, device="cuda").to(dtype) for _ in range(2))
        kl = torch.tensor(lens, device="cuda", dtype=torch.int32)
        out, lse = flash_forward(q, k, v, kl, d**-0.5, 0.0, True)
        ops = backward_operands(q, k, v, kl, out, lse, do)
        plain = lambda: flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, 0.0, True)  # noqa: E731
        pos = torch.arange(L, device="cuda")
        mask = (pos[None, :] <= pos[:, None])[None, None] & (pos[None, None, None, :] < kl[:, None, None, None])
        lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask, scale=d**-0.5, enable_gqa=H != KVH)
        library = lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do, retain_graph=True)  # noqa: E731
        pairs = sum(int(np.minimum(n, np.arange(L) + 1).sum()) for n in lens)
        qd_bytes, kv_bytes = 2 * b * H * L * d * item + 2 * b * H * L * 4, 2 * b * KVH * L * d * item
        record(f"flash_backward_dq[d{d} {H}/{KVH} causal lengths {tag}]", f"K5{f}",
               lambda: (_launch_dq(*ops, d**-0.5, 0.0, True),), plain, library, 6 * H * d * pairs,
               qd_bytes + kv_bytes + b * H * L * d * item, outputs=(0,),
               grid=(-(-L // dq_block_q(L)), b * H, dq_splits(b, H, L, L, sms, d=d)), phase=None, **kw)
        record(f"flash_backward_dkv[d{d} {H}/{KVH} causal lengths {tag}]", f"K6{f}",
               lambda: _launch_dkv(*ops, d**-0.5, 0.0, True), plain, library, 8 * H * d * pairs,
               qd_bytes + 2 * kv_bytes, outputs=(1, 2),
               grid=(-(-L // DKV_BLOCK_K), b * KVH, dkv_splits(b, H, KVH, L, L, sms, d=d)), phase=None, **kw)
        del q, k, v, do, out, lse, ops, lq, lk, lv, lib_out, mask


# phase 3's rows past head dim 128 (head_dim_checks), by instance: K1's rows (head dim, rows of 729 tokens,
# the phase that runs the bf16 row at that shape or None); the prefill (b, tokens, kv lengths: phase 4's
# batch) and its (head dim, query heads, kv heads), the first the phase's own; the phase; the kernel ids'
# suffixes in bf16 and fp32; the generator's seed; tf32: the fp32 K1/K2/K5/K6 rows' bound is 3xTF32's
UP_TO_256 = dict(k1=((192, 64, None), (256, 64, None)), prefill=(2, 743, [743, 700]),
                 rows=((256, 14, 2), (192, 14, 2)), phase="hd256", ids=("", "-f32"), seed=19)
# [hd512]'s tower runs K1 at d 288 over 32 frames x 4 heads for its single request
PAST_256 = dict(k1=((288, 32 * 4, "hd512"), (320, 64, None), (512, 64, None), (1024, 64, None)),
                prefill=(2, 743, [743, 700]), rows=((512, 7, 1), (320, 8, 2), (1024, 4, 1)), phase="hd512",
                ids=("-wide", "-wide-f32"), seed=20, tf32=True)


def head_dim_checks(record, fwd_grid, sms, spec):
    """Phase 3, the instances past head dim 128, in bf16 and in fp32 (``spec``:
    :data:`UP_TO_256`, the 192 and 256 instances of ``flash_fwd.cu``,
    ``flash_fwd_f32.cu``, ``flash_bwd.cu`` and ``flash_bwd_f32.cu``; or
    :data:`PAST_256`, the wide kernels of ``flash_wide.cu`` and
    ``flash_wide_f32.cu``, whose head dim is a runtime argument), each against
    its plain twin on the card at its type's gate (past it,
    :func:`float64_referee` against the float64 twin where the row has one),
    beside SDPA (its backward for K5/K6), fp32 bounds at the fp32 peak (past
    256, K1, K2, K5 and K6 at a third of the TF32 peak: 3xTF32): K1
    over rows of 729 at each of ``spec["k1"]``'s head dims; K2, K5 and K6 at
    the prefill (b 2, 743 tokens, causal, lengths 743 / 700) with each of
    ``spec["rows"]``'s heads; at the first of them, the phase's own shape, K2
    forced to 3 chunks with its merge, K6 at its default split with its sum
    pass and forced to 1 and 7 splits, K5 forced to 3, K5's sum pass alone,
    and the merge alone over 5 chunks of 10,402 rows, chunks with no tile or
    all masked among them. The bf16 rows at the phase's own shapes (K1 where
    ``spec["k1"]`` names the phase, the first prefill at the default split)
    take their launches from it; the rest are checks only."""
    import torch
    import torch.nn.functional as F

    from hicom_tpu_torch.ops.flash_attention import (DKV_BLOCK_K, WIDE_BLOCK_Q, WIDE_FROM, _launch, _launch_dkv,
                                                     _launch_dq, _launch_merge, _launch_part_sum, backward_operands,
                                                     dkv_splits, dq_block_q, dq_splits, flash_backward_reference,
                                                     flash_forward, flash_reference, fullblock_attention,
                                                     merge_partials_reference, sum_partials_reference,
                                                     wide_column_blocks)

    gen = torch.Generator("cuda").manual_seed(spec["seed"])

    def exact_forward(q, k, v, kl, d, causal):  # the float64 twin, for a row past its gate
        return lambda: flash_reference(q.double(), k.double(), v.double(), kl, d**-0.5, 0.0, causal)[0]

    for dtype, f in zip((torch.bfloat16, torch.float32), spec["ids"]):
        bf16 = dtype == torch.bfloat16
        item, tag = (2, "bf16") if bf16 else (4, "fp32")
        kw = dict(gate=BF16_GATE) if bf16 else dict(gate=FP32_GATE, flops_rate=FP32_PEAK)
        # the wide fp32 kernels multiply in 3xTF32: three TF32 products a product
        kw3 = dict(kw, flops_rate=TF32_PEAK / 3) if spec.get("tf32") and not bf16 else kw
        gate = kw["gate"]

        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        for d, bh, phase in spec["k1"]:
            L = 729
            q, k, v = rn(bh, L, d), rn(bh, L, d), rn(bh, L, d)
            record(f"fullblock_attention[{bh}x729 d{d} {tag}]", f"K1{f}", lambda: fullblock_attention(q, k, v, d**-0.5),
                   lambda: flash_reference(q[:, None], k[:, None], v[:, None], None, d**-0.5, 0.0, False)[0][:, 0],
                   lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], scale=d**-0.5),
                   4 * bh * L * L * d, 4 * bh * L * d * item + bh * L * 4,
                   grid=fwd_grid(bh, 1, L, L, d, fp32=not bf16), phase=phase if bf16 else None,
                   exact_fn=lambda: exact_forward(q[:, None], k[:, None], v[:, None], None, d, False)()[:, 0], **kw3)
            del q, k, v

        b, L, lens = spec["prefill"]
        kl = torch.tensor(lens, device="cuda", dtype=torch.int32)
        pos = torch.arange(L, device="cuda")
        mask = (pos[None, :] <= pos[:, None])[None, None] & (pos[None, None, None, :] < kl[:, None, None, None])
        pairs = sum(int(np.minimum(n, np.arange(L) + 1).sum()) for n in lens)
        for i, (d, H, KVH) in enumerate(spec["rows"]):
            main = i == 0
            phase = spec["phase"] if bf16 and main else None
            label = f"prefill {spec['phase']} d{d} {tag}" if main else f"prefill {H}/{KVH} d{d} {tag}"
            valid = (pos[None, :] < kl[:, None])[:, None, :].expand(b, H, L)
            q, k, v, do = rn(b, H, L, d), rn(b, KVH, L, d), rn(b, KVH, L, d), rn(b, H, L, d)
            fwd_bytes = 2 * b * H * L * d * item + 2 * KVH * sum(lens) * d * item + b * H * L * 4
            exact = exact_forward(q, k, v, kl, d, True)
            record(f"flash_forward[{label}]", f"K2{f}", lambda: flash_forward(q, k, v, kl, d**-0.5, 0.0, True),
                   lambda: flash_reference(q, k, v, kl, d**-0.5, 0.0, True),
                   lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=d**-0.5, enable_gqa=True),
                   4 * H * d * pairs, fwd_bytes, valid, grid=fwd_grid(b, H, L, L, d, fp32=not bf16), phase=phase,
                   exact_fn=exact, **kw3)
            if main:  # the split path at this width: 3 chunks of the key tiles, then the merge kernel
                record(f"flash_forward[{label} split 3]", f"K2{f}",
                       lambda: _launch(q, k, v, kl, d**-0.5, 0.0, True, n_split=3),
                       lambda: flash_reference(q, k, v, kl, d**-0.5, 0.0, True), None,
                       4 * H * d * pairs, fwd_bytes, valid, grid=fwd_grid(b, H, L, L, d, 3, fp32=not bf16),
                       phase=None, exact_fn=exact, **kw3)
            out, lse = flash_forward(q, k, v, kl, d**-0.5, 0.0, True)
            ops = backward_operands(q, k, v, kl, out, lse, do)
            plain = lambda: flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, 0.0, True)  # noqa: E731
            lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask, scale=d**-0.5, enable_gqa=True)
            library = lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do, retain_graph=True)  # noqa: E731
            qd_bytes, kv_bytes = 2 * b * H * L * d * item + 2 * b * H * L * 4, 2 * b * KVH * L * d * item
            dq_bytes, dkv_bytes = qd_bytes + kv_bytes + b * H * L * d * item, qd_bytes + 2 * kv_bytes
            dq_flops, dkv_flops = 6 * H * d * pairs, 8 * H * d * pairs
            n_dq, n_dkv = dq_splits(b, H, L, L, sms, d=d), dkv_splits(b, H, KVH, L, L, sms, d=d)

            def dq_grid(n):  # K5's blocks of query rows (64 past 256, times its clusters' CTAs on z)
                rows = WIDE_BLOCK_Q if d > WIDE_FROM else dq_block_q(L)
                return -(-L // rows), b * H, n * wide_column_blocks(d, "dq")

            def dkv_grid(n):  # K6's blocks of 64 keys
                return -(-L // DKV_BLOCK_K), b * KVH, n * wide_column_blocks(d, "dkv")

            record(f"flash_backward_dq[{label}]", f"K5{f}", lambda: (_launch_dq(*ops, d**-0.5, 0.0, True),), plain,
                   library, dq_flops, dq_bytes, outputs=(0,), grid=dq_grid(n_dq), phase=phase, **kw3)
            record(f"flash_backward_dkv[{label}]", f"K6{f}", lambda: _launch_dkv(*ops, d**-0.5, 0.0, True), plain,
                   library, dkv_flops, dkv_bytes, outputs=(1, 2), grid=dkv_grid(n_dkv), phase=phase, **kw3)
            if main:
                for n_split in (1, 7):
                    record(f"flash_backward_dkv[{label} split {n_split}]", f"K6{f}",
                           lambda: _launch_dkv(*ops, d**-0.5, 0.0, True, n_split=n_split), plain, None, dkv_flops,
                           dkv_bytes, outputs=(1, 2), grid=dkv_grid(n_split), phase=None, **kw3)
                record(f"flash_backward_dq[{label} split 3]", f"K5{f}",
                       lambda: (_launch_dq(*ops, d**-0.5, 0.0, True, n_split=3),), plain, None, dq_flops, dq_bytes,
                       outputs=(0,), grid=dq_grid(3), phase=None, **kw3)
                N = b * KVH * L * d
                dk_part, dv_part = (torch.randn(n_dkv, N, generator=gen, device="cuda") for _ in range(2))
                record(f"flash_dkv_sum[{label}, {n_dkv} splits]", f"K6{f}-sum",
                       lambda: _launch_part_sum((dk_part, d**-0.5), (dv_part, 1.0), dtype=dtype),
                       lambda: (sum_partials_reference(dk_part, d**-0.5, dtype),
                                sum_partials_reference(dv_part, 1.0, dtype)), None,
                       2 * n_dkv * N, 2 * (n_dkv * N * 4 + N * item), outputs=2, grid=(-(-N // 4 // 128), 2),
                       flops_rate=FP32_PEAK, phase=phase, gate=gate)
                n, N = 3, b * H * L * d
                part = torch.randn(n, N, generator=gen, device="cuda")
                record(f"flash_dq_sum[{label}, {n} chunks]", f"K5{f}-sum",
                       lambda: _launch_part_sum((part, d**-0.5), dtype=dtype),
                       lambda: sum_partials_reference(part, d**-0.5, dtype), None, n * N, n * N * 4 + N * item,
                       grid=(-(-N // 4 // 128), 1), flops_rate=FP32_PEAK, phase=None, gate=gate)
                del dk_part, dv_part, part
            del q, k, v, do, out, lse, ops, lq, lk, lv, lib_out
            torch.cuda.empty_cache()
        del mask
        n, rows, d = 5, 14 * 743, spec["rows"][0][0]  # the merge alone, chunks with no tile or all masked
        o = torch.randn(n, rows, d, generator=gen, device="cuda") * 50
        m = torch.randn(n, rows, generator=gen, device="cuda") * 3
        m[1], m[3, : rows // 2] = -1e30, float("-inf")
        l = torch.rand(n, rows, generator=gen, device="cuda") * 50 + 1
        record(f"flash_merge[{rows} rows d{d} {tag}, {n} chunks]", "K2-merge", lambda: _launch_merge(o, m, l, dtype),
               lambda: merge_partials_reference(o, m, l, dtype), None, 4 * n * rows * d,
               n * rows * (d + 2) * 4 + rows * (d * item + 4), outputs=2, grid=(-(-rows // 4),), flops_rate=FP32_PEAK,
               phase=None, gate=gate)
        del o, m, l


def cut_depth(cfg, layers: int = None):
    """``cfg`` with ``layers`` decoder, tower and guide-encoder layers (all of them with None)."""
    import dataclasses

    if layers is None:
        return cfg
    return cfg.replace(text_config=dataclasses.replace(cfg.text_config, num_hidden_layers=layers),
                       vision_config=dataclasses.replace(cfg.vision_config, num_hidden_layers=layers),
                       guide_text_config=dataclasses.replace(cfg.guide_text_config, num_hidden_layers=layers))


def serving_config(layers: int = None):
    """The released HICom-7B serving configuration (bf16), optionally cut in depth."""
    from hicom_tpu_torch.config import HIComConfig, Qwen2Config, SiglipTextConfig, SiglipVisionConfig

    return cut_depth(HIComConfig(
        text_config=Qwen2Config(), vision_config=SiglipVisionConfig(), guide_text_config=SiglipTextConfig(),
        mm_vision_tower="google/siglip-so400m-patch14-384", mm_projector_type="local43_global32", use_guide="direct",
        num_frames=32, dtype="bfloat16"), layers)


def anyres_config(layers: int = None):
    """The reference's llava1.5 anyres ablation (``mlp2x_gelu_anyres.sh``):
    so400m, the mlp2x_gelu projector, anyres_max_9 over the (1x1),...,(6x6)
    pinpoints under spatial_unpad, Qwen2.5-7B (bf16); no guide."""
    return serving_config(layers).replace(
        mm_projector_type="mlp2x_gelu", use_guide=None, image_aspect_ratio="anyres_max_9",
        mm_patch_merge_type="spatial_unpad", image_grid_pinpoints="(1x1),...,(6x6)")


def clip_config(layers: int = None):
    """HICom-7B on the CLIP-L/336 tower (the reference's second tower): its
    published widths, local43_global32 with the direct guide and no clip
    scale, the compression keys 768 wide (its projection), Qwen2.5-7B (bf16)."""
    from hicom_tpu_torch.config import ClipTextConfig, ClipVisionConfig, projector_qk_dim

    return cut_depth(serving_config().replace(
        vision_config=ClipVisionConfig(), guide_text_config=ClipTextConfig(),
        mm_vision_tower="openai/clip-vit-large-patch14-336", use_clip_scale="",
        projector_qk_dim=projector_qk_dim(ClipVisionConfig())), layers)


def baseline_05b_config(layers: int = None):
    """``BASELINE.json`` configs 1 and 2: HICom on the so400m tower with local
    compression only (``local43``) and the direct guide, over
    Qwen2.5-0.5B-Instruct's published widths (vocab 151,936, hidden 896, MLP
    4,864, 24 layers, 14 query / 2 kv heads of 64, rope theta 1e6, tied
    embeddings), bf16, 8 frames."""
    from hicom_tpu_torch.config import Qwen2Config

    text = Qwen2Config(vocab_size=151936, hidden_size=896, intermediate_size=4864, num_hidden_layers=24,
                       num_attention_heads=14, num_key_value_heads=2, head_dim=64, rope_theta=1e6,
                       tie_word_embeddings=True)
    return cut_depth(serving_config().replace(text_config=text, mm_projector_type="local43", num_frames=8), layers)


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


def make_train_batch(cfg, seed: int = 0):
    """The batch-of-2 request as a training batch: labels are the prompt ids
    with the first 8 and the padding set to IGNORE_INDEX."""
    from hicom_tpu_torch.constants import IGNORE_INDEX

    batch, _ = make_requests(cfg, seed)
    labels = np.where(batch["attention_mask"], batch["input_ids"], IGNORE_INDEX)
    labels[:, :8] = IGNORE_INDEX
    return dict(batch, labels=labels)


@contextmanager
def plain_path():
    """Route attention to the plain paths while inside (kernels stay untouched)."""
    from hicom_tpu_torch.models import projector, qwen2
    from hicom_tpu_torch.ops import attention
    from hicom_tpu_torch.ops.flash_decode import decode_reference
    from hicom_tpu_torch.ops.local_attn import tile_reference

    saved = attention.flash_route, projector.fused_tile_attention, qwen2.flash_decode
    attention.flash_route = lambda *a, **k: None
    projector.fused_tile_attention = tile_reference
    qwen2.flash_decode = lambda q, k, v, m, k_scale=None, v_scale=None, scale=None: decode_reference(
        q, k, v, m, k_scale, v_scale, scale)
    try:
        yield
    finally:
        attention.flash_route, projector.fused_tile_attention, qwen2.flash_decode = saved


def counters(train: bool = False):
    """The serving path's kernel wrappers by name, and the flash backward's with ``train``."""
    from hicom_tpu_torch.ops.flash_attention import flash_backward, flash_forward, fullblock_attention
    from hicom_tpu_torch.ops.flash_decode import flash_decode
    from hicom_tpu_torch.ops.local_attn import fused_tile_attention

    fns = (fullblock_attention, flash_forward, flash_decode, fused_tile_attention) + ((flash_backward,) if train else ())
    return {f.__name__: f for f in fns}


def plain_routes() -> dict:
    """The calls on the card that a kernel's contract sent to the plain path
    since the last reset, by kernel (``cuda_build.plain_route``)."""
    from hicom_tpu_torch.ops.cuda_build import plain_route

    return dict(plain_route.counts)


PHASE_START = [0.0]  # when the running phase began (perf_counter), for the "[label] phase s" lines


def phase_seconds(label: str) -> None:
    """Log the seconds since the last phase ended: the run's time by phase,
    the first thing to read when the run nears its limit."""
    now = time.perf_counter()
    log(f"[{label}] phase {now - PHASE_START[0]:.1f} s")
    PHASE_START[0] = now


def on_contract(label: str, value=None):
    """After a phase: every one-token decode step of it took K3 (the phases
    run bf16 at head dims and groups K3 takes), so no plain-route count
    moved. Resets the counts for the next phase, logs the phase's seconds;
    returns ``value``."""
    from hicom_tpu_torch.ops.cuda_build import plain_route

    phase_seconds(label)
    counts = plain_routes()
    plain_route.reset()
    if any(counts.values()):
        raise AssertionError(f"[{label}] calls went to the plain path by a kernel's contract: {counts}")
    return value


def main_path(card: str, cfg=None, label: str = "slice", then=None):
    """Phase 4: a 7B slice answering 3 requests (the released configuration,
    or ``cfg``); returns launch counts. ``then(hc)`` runs on the same model
    before it is freed (``[serve-engine]``)."""
    import torch

    from hicom_tpu_torch.api import HICom, build_model

    cfg = cfg or serving_config()
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    log(f"[{label}] built the model ({cfg.mm_vision_tower}, {cfg.mm_projector_type}, decoder "
        f"{cfg.text_config.hidden_size} wide x {cfg.text_config.num_hidden_layers}) with seeded weights in "
        f"{time.perf_counter() - t0:.1f} s, {sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params")
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
    log(f"[{label}] launches on the main path: {launches} | plain-route calls {plain_routes()}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[{label}] the main path never launched {name}")

    vocab = cfg.text_config.vocab_size
    for out in (out2, out1):
        if not (np.all(np.isfinite(out)) and out.min() >= 0 and out.max() < vocab):
            raise AssertionError(f"generated ids out of range: {out}")
    log(f"[{label}] batch of 2 ids: {out2.tolist()}")
    log(f"[{label}] single ids: {out1.tolist()}")

    ttfts = []
    for _ in range(2):
        t0 = time.perf_counter()
        hc.generate(**single, max_new_tokens=1)
        ttfts.append(time.perf_counter() - t0)
    ttft = min(ttfts)
    decode_tps, stages = stage_breakdown(hc, video_front(hc, single),
                                         label="stages" if label == "slice" else f"{label}-stages")
    projector_sync_check(model, single)
    size, n_vis = cfg.vision_config.image_size, model.visual_token_count(cfg.num_frames, "video")
    log(f"[{label}] {card} | 3 requests ({cfg.num_frames} frames of {size}x{size}, {n_vis} visual tokens, 16 new "
        f"tokens): batch-of-2 request {t_batch:.3f} s, single request {t_single:.3f} s | TTFT {ttft * 1e3:.1f} ms | "
        f"decode {decode_tps:.1f} tokens/s (single stream) | peak memory {peak_gb:.2f} GB")
    if label == "slice":  # the bf16 model's last-token logits of the single request, for [serve-int8]
        BF16_REFERENCE.update(logits=last_logits(model, with_mask(single)).cpu(), tower_ms=stages["vision tower"])
    if then is not None:
        then(hc)
    del model, hc
    torch.cuda.empty_cache()
    return launches


def greedy_with_tops(hc, req, n: int):
    """``hc.generate(**req)`` greedy for ``n`` tokens: (row 0's ids, each
    step's top-2 logits (n, 2))."""
    import torch

    tops, logits = [], hc.model.logits

    def recording(h):
        out = logits(h)
        tops.append(out[:, -1].float().topk(2, dim=-1).values[0])
        return out

    hc.model.logits = recording
    try:
        out = hc.generate(**req, max_new_tokens=n)
    finally:
        del hc.model.logits
    return out[0].tolist(), torch.stack(tops).cpu()


def baseline_05b_checks(card: str, hc) -> dict:
    """[baseline-0.5b]'s checks on the model of its main path: the single
    8-frame request's 16 greedy ids against the same model's under
    :func:`plain_path` (equal, or first apart at a near-tie of the plain run,
    ``NEAR_TIE``), its last-token logits within :func:`agreement`'s gate of the
    plain path's, then one single-image request (``BASELINE.json`` config 1:
    one frame, K4 on 1 x 3 x 3 tiles) through K1-K4. Returns the image
    request's launches."""
    import torch

    from hicom_tpu_torch.constants import IMAGE_TOKEN_INDEX

    cfg, model = hc.config, hc.model
    n_vis = model.visual_token_count(cfg.num_frames, "video")
    if BASELINE_PREFILL != (64 - 1 + n_vis, 41 - 1 + n_vis):
        raise AssertionError(f"[baseline-0.5b] {n_vis} visual tokens: BASELINE_PREFILL is stale")
    _, single = make_requests(cfg)
    got, _ = greedy_with_tops(hc, single, 16)
    with plain_path():
        ref, tops = greedy_with_tops(hc, single, 16)
    div = first_divergence(got, ref, tops)
    log(f"[baseline-0.5b] single request's 16 greedy ids, kernel path vs plain path on the card: "
        + ("equal" if div is None else f"first apart at {div[0]}, top-2 gap there {div[1]:.4g} of |top logit| "
           f"(allowed {NEAR_TIE:.3g})"))
    if div is not None and not div[1] <= NEAR_TIE:
        raise AssertionError(f"[baseline-0.5b] greedy ids {got} differ from the plain path's {ref}")
    got_l = last_logits(model, with_mask(single))
    with plain_path():
        ref_l = last_logits(model, with_mask(single))
    err, ratio, rms, top = agreement(got_l, ref_l)
    log(f"[baseline-0.5b] last-token logits, kernel vs plain path: max_abs_err {err:.3g}, worst err/tol {ratio:.3f} "
        f"(tol 2^-6|ref| + 2^-5 rms, ref rms {rms:.3g}, max {top:.3g}), top-1 {int(got_l.argmax())} vs "
        f"{int(ref_l.argmax())}")
    if not (torch.isfinite(got_l).all() and ratio <= 1):
        raise AssertionError(f"[baseline-0.5b] kernel-path logits disagree with the plain path ({ratio})")

    rng = np.random.default_rng(7)
    ids = rng.integers(0, cfg.text_config.vocab_size, (1, 64))
    ids[0, 5] = IMAGE_TOKEN_INDEX
    size = cfg.vision_config.image_size
    image = rng.uniform(-1, 1, (1, 1, 3, size, size)).astype(np.float32)
    fns = counters()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = hc.generate(ids, frames=image, guide_ids=single["guide_ids"], modal="image", max_new_tokens=16)
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in fns.items()}
    log(f"[baseline-0.5b] {card} | single-image request ({size}x{size}, "
        f"{model.visual_token_count(1, 'image')} visual tokens, 16 new tokens) {wall:.3f} s | launches {launches} "
        f"| ids {out[0].tolist()}")
    if min(launches.values()) <= 0 or not (out.min() >= 0 and out.max() < cfg.text_config.vocab_size):
        raise AssertionError(f"[baseline-0.5b] the image request did not run through K1-K4: {launches}")
    return launches


def baseline_05b_phase(card: str) -> dict:
    """[baseline-0.5b]: the main path (:func:`main_path`: a batch of 2 and a
    single 8-frame request, TTFT, decode rate, stages, the sync check, peak
    memory) at :func:`baseline_05b_config`'s full width and depth, then
    :func:`baseline_05b_checks` on the same model. Returns the launches of
    the main path ("baseline-0.5b") and of the image request
    ("baseline-0.5b-image")."""
    out = {}

    def then(hc):
        out["baseline-0.5b-image"] = baseline_05b_checks(card, hc)

    out["baseline-0.5b"] = main_path(card, baseline_05b_config(), "baseline-0.5b", then=then)
    return out


def fp32_route_phase(card: str) -> dict:
    """[fp32-route]: the decoder's route on K3's contract, on the card.
    A model at ``selftest.py``'s tiny widths (the decoder 64 wide over 4 query
    and 2 kv heads: head dim 16; ``local43_global32``, no guide) in fp32,
    drawn from a seed on the CPU and exported under ``build/``, is loaded by
    ``model_init(..., dtype="float32")`` on the card and on the CPU. One
    4-frame video through ``mm_infer`` on each: the same string, nothing
    raised, no kernel launched on the card, and a positive plain-route count
    for K3, whose contract refuses the model's decode steps (fp32, head dim
    16); JAX's rule keeps its other attention calls plain (short sequences,
    head dim 16 grouped, the 4 x 4 patch grid untiled by 3 x 3). Returns the
    card's plain-route counts."""
    import dataclasses
    import os
    import shutil

    import torch

    from hicom_tpu_torch import selftest, tiny_test_config
    from hicom_tpu_torch.api import build_model, mm_infer, model_init
    from hicom_tpu_torch.config import Qwen2Config
    from hicom_tpu_torch.ops.cuda_build import plain_route
    from hicom_tpu_torch.weights import export_hf_checkpoint

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_fp32_route")
    shutil.rmtree(root, ignore_errors=True)
    tower, ckpt = os.path.join(root, "siglip-selftest-width"), os.path.join(root, "hicom-selftest-width")
    os.makedirs(tower)
    text = Qwen2Config(**selftest.QWEN, head_dim=16, eos_token_id=2, pad_token_id=0)
    cfg = tiny_test_config(text_config=text, use_guide=None, mm_vision_tower=tower)
    with open(os.path.join(tower, "config.json"), "w") as f:
        json.dump({"model_type": "siglip", "vision_config": dataclasses.asdict(cfg.vision_config),
                   "text_config": dataclasses.asdict(cfg.guide_text_config)}, f)
    export_hf_checkpoint(build_model(cfg, device="cpu", seed=5, std=0.2).state_dict(), cfg, ckpt)
    write_word_tokenizer(ckpt, text.vocab_size, text.eos_token_id)
    size = cfg.vision_config.image_size
    pixels = np.random.default_rng(23).uniform(-1, 1, (cfg.num_frames, 3, size, size)).astype(np.float32)
    strings, counts, launched = {}, {}, {}
    for device in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        hc, _, tok = model_init(ckpt, dtype="float32", device=device)
        fns = counters()
        before = {n: f.launches for n, f in fns.items()}
        plain_route.reset()
        strings[device] = mm_infer(pixels, "w10 w20 w30 w40", hc, tok, max_new_tokens=8)
        launched[device] = {n: f.launches - before[n] for n, f in fns.items()}
        counts[device] = plain_routes()
        log(f"[fp32-route] {device}: {strings[device]!r} ({time.perf_counter() - t0:.1f} s with the load) | "
            f"launches {launched[device]} | plain-route calls {counts[device]}")
        del hc
    plain_route.reset()
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    if strings[DEVICE] != strings["cpu"] or not strings["cpu"]:
        raise AssertionError(f"[fp32-route] the card's string {strings[DEVICE]!r} is not the CPU's {strings['cpu']!r}")
    if any(launched[DEVICE].values()) or counts[DEVICE]["K3"] <= 0:
        raise AssertionError(f"[fp32-route] fp32 calls reached a kernel or skipped the plain route: "
                             f"{launched[DEVICE]}, {counts[DEVICE]}")
    return counts[DEVICE]


def fp32_serve_phase(card: str) -> dict:
    """[fp32-serve]: HICom-7B in fp32 at full width and depth
    (``serving_config()`` with ``dtype="float32"``: the so400m tower over 32
    frames, ``local43_global32`` with the direct guide, Qwen2.5-7B), built by
    ``build_model(..., seed=0)`` with the decoder's norms at 1. TF32 must be
    off everywhere. Phase 4's 3 requests (a right-padded batch of 2, then one
    alone, 16 new tokens) through ``HICom.generate``: K1 (each tower layer),
    K2 (each decoder layer's prefill and the global compressor, split with
    its merge) and K4 (the local compressor) launch exactly as often as the
    phase reckons from the model's depth, and every decode step takes the
    masked ``sdpa`` by K3's contract (no fp32 instance), counted in
    ``plain_route`` once per layer and step. Then the single request's 8
    greedy ids and last-token logits against ``plain_path()`` on the card,
    the logits within ``FP32_GATE``; TTFT, decode rate, stages and peak
    memory. Returns the launches of the 3 requests."""
    import torch

    from hicom_tpu_torch.api import HICom, build_model
    from hicom_tpu_torch.ops.cuda_build import plain_route
    from hicom_tpu_torch.ops.flash_attention import forward_splits

    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("[fp32-serve] TF32 is on: an fp32 product would drop to a 10-bit mantissa")
    cfg = serving_config().replace(dtype="float32")
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE, seed=0)
    norms_at_one(model)
    torch.cuda.synchronize()
    log(f"[fp32-serve] built HICom-7B in fp32 with seeded weights in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    hc = HICom(config=cfg, model=model, eos_token_id=cfg.text_config.eos_token_id, cache_len=4096)
    batch, single = make_requests(cfg)
    hc.generate(**single, max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()

    steps = [0]
    hook = model.model.register_forward_pre_hook(
        lambda mod, args: steps.__setitem__(0, steps[0] + (args[0].shape[1] == 1)))
    fns = counters()
    for f in fns.values():
        f.launches = 0
    plain_route.reset()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out2 = hc.generate(**batch, max_new_tokens=16)
        t_batch = time.perf_counter() - t0
        t0 = time.perf_counter()
        out1 = hc.generate(**single, max_new_tokens=16)
        t_single = time.perf_counter() - t0
    finally:
        hook.remove()
    launches = {name: f.launches for name, f in fns.items()}
    k3_plain = plain_routes()["K3"]
    plain_route.reset()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers, calls = cfg.text_config.num_hidden_layers, 2
    reckoned = {"fullblock_attention": calls * cfg.vision_config.num_hidden_layers,
                "flash_forward": calls * (layers + 1), "flash_decode": 0, "fused_tile_attention": calls}
    splits = [forward_splits(b, 9, 32, 32 * 27 * 27, d=128) for b in (2, 1)]
    log(f"[fp32-serve] launches {launches} (reckoned {reckoned}; the global compressor split into {splits} chunks "
        f"and merged) | decode steps {steps[0]}, K3 plain-route calls {k3_plain} (reckoned {steps[0] * layers})")
    if launches != reckoned or min(splits) < 2:
        raise AssertionError(f"[fp32-serve] launches {launches} are not the reckoned {reckoned}")
    if steps[0] <= 0 or k3_plain != steps[0] * layers:
        raise AssertionError(f"[fp32-serve] {k3_plain} plain-route decode calls for {steps[0]} steps x {layers} layers")
    vocab = cfg.text_config.vocab_size
    for out in (out2, out1):
        if not (out.min() >= 0 and out.max() < vocab):
            raise AssertionError(f"[fp32-serve] generated ids out of range: {out}")
    log(f"[fp32-serve] batch of 2 ids: {out2.tolist()} | single ids: {out1.tolist()}")

    got, _ = greedy_with_tops(hc, single, 8)
    with plain_path():
        ref, tops = greedy_with_tops(hc, single, 8)
    got_l = last_logits(model, with_mask(single))
    with plain_path():
        ref_l = last_logits(model, with_mask(single))
    plain_route.reset()
    err, ratio, rms, top = agreement(got_l, ref_l, FP32_GATE)
    log(f"[fp32-serve] 8 greedy ids, kernel path {got} vs plain path {ref}: {'equal' if got == ref else 'DIFFER'} | "
        f"last-token logits: max_abs_err {err:.3g}, worst err/tol {ratio:.3f} (tol {gate_text(FP32_GATE)}, ref rms "
        f"{rms:.3g}, max {top:.3g})")
    if got != ref or not (torch.isfinite(got_l).all() and ratio <= 1):
        raise AssertionError(f"[fp32-serve] the kernel path departs from the plain path: ids {got} vs {ref}, "
                             f"logits worst err/tol {ratio}")

    ttfts = []
    for _ in range(2):
        t0 = time.perf_counter()
        hc.generate(**single, max_new_tokens=1)
        ttfts.append(time.perf_counter() - t0)
    decode_tps, _ = stage_breakdown(hc, video_front(hc, single), label="fp32-serve-stages")
    plain_route.reset()
    size = cfg.vision_config.image_size
    log(f"[fp32-serve] {card} | 3 requests ({cfg.num_frames} frames of {size}x{size}, 16 new tokens): batch-of-2 "
        f"request {t_batch:.3f} s, single request {t_single:.3f} s | TTFT {min(ttfts) * 1e3:.1f} ms | decode "
        f"{decode_tps:.1f} tokens/s (single stream) | peak memory {peak_gb:.2f} GB")
    del model, hc
    torch.cuda.empty_cache()
    return launches


def bit_sums(named, chunk: int = 1 << 26) -> dict:
    """{name: (sum, position-weighted sum) of the tensor's bits read as
    integers, modulo 2^64} on its device, over ``chunk``-element pieces: a
    change of any one element changes the first sum, so equal sums before and
    after a run witness bits unchanged without a host copy (17 GB for
    HICom-7B's frozen bf16 tensors, 34 GB in fp32, whose copies and host
    comparisons took most of [train]'s and [stage3-lora]'s seconds), where
    sums of the values in fp64 could miss a change of a low bit."""
    import torch

    out = {}
    with torch.no_grad():
        for n, p in named:
            flat = p.detach().reshape(-1).view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                                                1: torch.uint8}[p.element_size()])
            acc = torch.zeros(2, dtype=torch.int64, device=p.device)
            for i in range(0, flat.numel(), chunk):
                x = flat[i:i + chunk].to(torch.int64)
                acc[0] += x.sum()
                acc[1] += (x * (torch.arange(i, i + x.numel(), device=p.device) % 8191 + 1)).sum()
            out[n] = acc
    return out


def fp32_train_phase(card: str):
    """[fp32-train]: stage 2 of HICom-7B in fp32 at full width and depth
    (``serving_config()`` with ``dtype="float32"``; ``train_phase``'s recipe,
    batch and 3 steps), with TF32 off. Each step launches the flash backward
    (``csrc/flash_bwd_f32.cu``) once per decoder layer and once for the global
    compressor, and no tile or decode kernel; the frozen tensors keep their
    bits (``bit_sums``), every trained tensor whose gradient reaches AdamW's
    eps moves,
    the losses are finite; step 1's trained gradients on the kernel path are
    held to ``plain_path()``'s on the same weights and batch within
    ``FP32_GATE``, each tensor against its own rms (a gradient the softmax
    cancels, whose exact value is 0, is held below 2^-20 of the largest
    gradient on both paths instead). Returns the launches of the 3 steps."""
    import torch

    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.train.optimizer import build_optimizer, trainable_param_count
    from hicom_tpu_torch.train.train_step import batch_to_device, create_train_state, make_loss_fn, make_train_step

    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("[fp32-train] TF32 is on: an fp32 product would drop to a 10-bit mantissa")
    cfg = serving_config().replace(dtype="float32")
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE, seed=0)
    opt = build_optimizer(model, learning_rate=1e-3, guide_injector_lr=1e-3, total_steps=TRAIN_STEPS,
                          tunable_parts="mm_projector", use_guide="direct")
    state = create_train_state(model, opt, device=DEVICE)
    params = dict(model.named_parameters())
    trained = sorted(n for n, p in params.items() if p.requires_grad)
    frozen_before = bit_sums((n, p) for n, p in params.items() if n not in trained)
    trained_before = {n: params[n].detach().clone() for n in trained}
    batch = batch_to_device(make_train_batch(cfg), torch.device(DEVICE), torch.float32)
    torch.cuda.synchronize()
    log(f"[fp32-train] HICom-7B stage 2 in fp32: {trainable_param_count(model, 'mm_projector', 'direct') / 1e6:.1f} M "
        f"trained, {sum(p.numel() for n, p in params.items() if n not in trained) / 1e9:.2f} B frozen; built in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    def grads():
        return {n: params[n].grad.detach().clone() if params[n].grad is not None else torch.zeros_like(params[n])
                for n in trained}

    with plain_path():  # step 1's gradients on the plain path, from the same weights
        loss_p, _ = make_loss_fn(model)(batch)
        loss_p.backward()
    plain = grads()
    for p in model.parameters():
        p.grad = None
    step = make_train_step()
    reset_counts()
    times, metrics, fwd, per_step = run_steps(state, step, batch, n=1)
    got = grads()
    # a gradient the softmax cancels (the keys' bias) is rounding noise on both paths: held below the noise floor
    noise = 2**-20 * max(float(g.abs().max()) for g in plain.values())
    cancelled = [n for n in trained if float(plain[n].abs().max()) <= noise]
    loud = [n for n in cancelled if float(got[n].abs().max()) > noise]
    ratios = {n: agreement(got[n], plain[n], FP32_GATE)[1] for n in trained if n not in cancelled}
    worst = max((r, n) for n, r in ratios.items())
    log(f"[fp32-train] step 1's gradients, kernel vs plain path: loss {metrics[0]['loss']:.7f} vs "
        f"{float(loss_p.detach()):.7f}, {len(trained)} tensors, worst err/tol {worst[0]:.3f} ({worst[1]}; tol "
        f"{gate_text(FP32_GATE)} of each tensor); {len(cancelled)} cancelled tensors below {noise:.3g} on both "
        f"paths: {'yes' if not loud else loud}; err/tol by tensor "
        + " ".join(f"{n.split('mm_projector.')[-1]} {r:.3f}" for n, r in ratios.items()))
    if loud or not worst[0] <= 1:
        raise AssertionError(f"[fp32-train] kernel-path gradients depart from the plain path's: {worst}, {loud}")
    del plain, got, loss_p
    more = run_steps(state, step, batch, n=TRAIN_STEPS - 1)
    times, metrics, fwd, per_step = (a + b for a, b in zip((times, metrics, fwd, per_step), more))
    # a gradient below AdamW's eps moves its tensor by less than an ulp (as check_moved allows)
    with_grad = [n for n in trained if params[n].grad is not None and params[n].grad.abs().max().item() >= 1e-8]
    launches = log_steps("fp32-train", card, "HICom-7B stage 2 in fp32", model, cfg, batch, times, metrics, fwd,
                         per_step)
    n_layers = cfg.text_config.num_hidden_layers
    if per_step != [n_layers + 1] * TRAIN_STEPS:  # every decoder layer + the global compressor
        raise AssertionError(f"[fp32-train] flash backward launched {per_step} times per step, not {n_layers + 1}")
    if launches["fused_tile_attention"] or launches["flash_decode"] or not (
            launches["fullblock_attention"] and launches["flash_forward"]):
        raise AssertionError(f"[fp32-train] launches {launches}")
    after = bit_sums((n, params[n]) for n in frozen_before)
    changed = [n for n in frozen_before if not torch.equal(after[n], frozen_before[n])]
    still = [n for n in with_grad if torch.equal(params[n].detach(), trained_before[n])]
    if changed or still or not with_grad:
        raise AssertionError(f"[fp32-train] frozen tensors changed {changed[:3]}; trained tensors with a gradient "
                             f"that did not move {still[:3]} (of {len(with_grad)})")
    log(f"[fp32-train] checks: {len(frozen_before)} frozen tensors kept their bits; {len(with_grad)} of "
        f"{len(trained)} trained tensors had a gradient >= AdamW's eps (1e-8) and all moved")
    del model, state, opt, params, trained_before, batch
    torch.cuda.empty_cache()
    return launches


HD256_LAYERS = 4  # [hd256]'s depth: the tower, guide and decoder at full depth run in the other phases
HD256_STEPS = 2


def hd256_config(layers: int = HD256_LAYERS):
    """HICom-7B (``serving_config``: so400m, ``local43_global32`` with the
    direct guide, bf16) with its decoder's attention reshaped to 14 query and
    2 kv heads of 256, which keeps Qwen2.5-7B's projection sizes (q and o
    3,584 x 3,584, k and v 3,584 x 512): a width variant the JAX package
    builds (``Qwen2Config.head_dim`` is a field of its own), not a published
    checkpoint; decoder, tower and guide cut to ``layers``."""
    from hicom_tpu_torch.config import Qwen2Config

    return cut_depth(serving_config().replace(
        text_config=Qwen2Config(num_attention_heads=14, num_key_value_heads=2, head_dim=256)), layers)


def hd512_config(layers: int = HD256_LAYERS):
    """HICom-7B (``serving_config``) with its decoder's attention reshaped to
    7 query heads and 1 kv head of 512, which keeps Qwen2.5-7B's projection
    sizes (q and o 3,584 x 3,584, k and v 3,584 x 512), and its SigLIP tower
    to 4 heads of 288, which keeps so400m's 1,152 width and sends the tower's
    729-token attention to K1 at d 288 by JAX's one-block ``d % 8`` rule: a
    width variant the JAX package builds, not a published checkpoint;
    decoder, tower and guide cut to ``layers``."""
    import dataclasses

    from hicom_tpu_torch.config import Qwen2Config

    cfg = serving_config()
    return cut_depth(cfg.replace(
        text_config=Qwen2Config(num_attention_heads=7, num_key_value_heads=1, head_dim=512),
        vision_config=dataclasses.replace(cfg.vision_config, num_attention_heads=4)), layers)


def fp32_plain_logits(model, cfg, batch):
    """:func:`last_logits` of ``model``'s weights in fp32 (each bf16 weight
    exactly, TF32 off) on the plain path: the reference against which a bf16
    kernel path and a bf16 plain path are weighed (:func:`float64_referee`)
    where their logits exceed the gate between them."""
    import torch

    from hicom_tpu_torch.api import build_model

    m32 = build_model(cfg.replace(dtype="float32"), device=DEVICE, seed=0)
    m32.load_state_dict(model.state_dict())
    with plain_path():
        out = last_logits(m32, batch)
    del m32
    torch.cuda.empty_cache()
    return out


def hd256_phase(card: str) -> dict:
    """[hd256]: :func:`wide_heads_phase` on :func:`hd256_config`."""
    return wide_heads_phase(card, "hd256", hd256_config())


def hd512_phase(card: str) -> dict:
    """[hd512]: :func:`wide_heads_phase` on :func:`hd512_config`: the tower's
    attention on K1 at d 288, the decoder's prefill on K2 and its stage-2
    backward on K5/K6 at d 512 (``flash_wide.cu``)."""
    return wide_heads_phase(card, "hd512", hd512_config())


def wide_heads_phase(card: str, label: str, cfg) -> dict:
    """[hd256] or [hd512] (``label``): attention at a wide head dim on the
    main paths, at HICom-7B's full width (``cfg``: :func:`hd256_config` or
    :func:`hd512_config`, seeded by ``build_model``, the decoder's norms at 1)
    and 4 layers. Phase 4's 3 requests (a right-padded batch of 2, then one
    alone, 16 new tokens) through ``HICom.generate``: K1 (each tower layer),
    K2 (each decoder layer's prefill at the wide head dim, and the global
    compressor) and K4 launch as often as the phase reckons from the depth;
    each one-token step takes the masked ``sdpa`` by K3's contract (K3 has
    head dims 64 and 128), counted in ``plain_route`` once per layer and step
    and reset here. The single request's 8 greedy ids against
    ``plain_path()``'s on the card (equal, or first apart at a near-tie of
    the plain run, ``NEAR_TIE``) and its last-token logits within
    ``BF16_GATE``, or, past it, no further from the fp32 plain path on the
    same weights than the bf16 plain path is (:func:`float64_referee`, the
    rule of a kernel row above the gate). Then 2 stage-2 steps (``train_phase``'s recipe): K5/K6
    once per decoder layer (the wide head dim) and once for the global
    compressor (d 128) a step; step 1's trained gradients against ``plain_path()``'s on
    the same weights and batch, each tensor's difference within 5% of its
    norm (the 2-layer comparison's rule, per tensor; a gradient the softmax
    cancels, whose exact value is 0, held below 2^-16 of the largest gradient
    element on both paths); frozen tensors keep their bits, trained ones
    with a gradient move. Returns the serving launches of the 3 requests
    and the flash backward's of the steps, by wrapper and by (kernel,
    library) (``flash_attention.source_launches``: past head dim 256 the wide
    kernels' own, apart from the global compressor's d 128)."""
    import torch

    from hicom_tpu_torch.api import HICom, build_model
    from hicom_tpu_torch.ops.cuda_build import plain_route
    from hicom_tpu_torch.ops.flash_attention import source_launches
    from hicom_tpu_torch.train.optimizer import build_optimizer
    from hicom_tpu_torch.train.train_step import batch_to_device, create_train_state, make_loss_fn, make_train_step

    tc, vc = cfg.text_config, cfg.vision_config
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE, seed=0)
    norms_at_one(model)
    q_proj = model.model.layers[0].self_attn.q_proj.weight
    torch.cuda.synchronize()
    log(f"[{label}] built HICom-7B with {tc.num_attention_heads} / {tc.num_key_value_heads} decoder heads of "
        f"{tc.head_dim} (q_proj {tuple(q_proj.shape)}), tower heads of {vc.head_dim}, {tc.num_hidden_layers} "
        "layers, seeded weights in "
        f"{time.perf_counter() - t0:.1f} s, {sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params")
    hc = HICom(config=cfg, model=model, eos_token_id=tc.eos_token_id, cache_len=4096)
    batch, single = make_requests(cfg)
    hc.generate(**single, max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()

    steps = [0]
    hook = model.model.register_forward_pre_hook(
        lambda mod, args: steps.__setitem__(0, steps[0] + (args[0].shape[1] == 1)))
    fns = counters()
    for f in fns.values():
        f.launches = 0
    plain_route.reset()
    source_launches.clear()
    try:
        t0 = time.perf_counter()
        out2 = hc.generate(**batch, max_new_tokens=16)
        out1 = hc.generate(**single, max_new_tokens=16)
        wall = time.perf_counter() - t0
    finally:
        hook.remove()
    launches = {name: f.launches for name, f in fns.items()}
    fwd_sources = {key: n for key, n in source_launches.items() if key[0][:2] in ("K1", "K2")}
    k3_plain = plain_routes()["K3"]
    plain_route.reset()
    layers, calls = tc.num_hidden_layers, 2
    reckoned = {"fullblock_attention": calls * cfg.vision_config.num_hidden_layers,
                "flash_forward": calls * (layers + 1), "flash_decode": 0, "fused_tile_attention": calls}
    log(f"[{label}] launches {launches} (reckoned {reckoned}); by kernel and library {fwd_sources} | decode steps "
        f"{steps[0]}, K3 plain-route calls {k3_plain} (reckoned {steps[0] * layers}) | 3 requests {wall:.3f} s")
    if launches != reckoned:
        raise AssertionError(f"[{label}] launches {launches} are not the reckoned {reckoned}")
    if steps[0] <= 0 or k3_plain != steps[0] * layers:
        raise AssertionError(f"[{label}] {k3_plain} plain-route decode calls for {steps[0]} steps x {layers} layers")
    for out in (out2, out1):
        if not (out.min() >= 0 and out.max() < tc.vocab_size):
            raise AssertionError(f"[{label}] generated ids out of range: {out}")
    log(f"[{label}] batch of 2 ids: {out2.tolist()} | single ids: {out1.tolist()}")

    got, _ = greedy_with_tops(hc, single, 8)
    with plain_path():
        ref, tops = greedy_with_tops(hc, single, 8)
    div = first_divergence(got, ref, tops)
    got_l = last_logits(model, with_mask(single))
    with plain_path():
        ref_l = last_logits(model, with_mask(single))
    plain_route.reset()
    err, ratio, rms, top = agreement(got_l, ref_l)
    log(f"[{label}] 8 greedy ids, kernel path {got} vs plain path {ref}: "
        + ("equal" if div is None else f"first apart at {div[0]}, top-2 gap there {div[1]:.4g} of |top logit| "
           f"(allowed {NEAR_TIE:.3g})")
        + f" | last-token logits: max_abs_err {err:.3g}, worst err/tol {ratio:.3f} (tol {gate_text(BF16_GATE)}, "
        f"ref rms {rms:.3g}, max {top:.3g})")
    close = ratio <= 1
    if not close:  # decided as a kernel row above the gate is: both paths against the same weights in fp32
        exact = fp32_plain_logits(model, cfg, with_mask(single))
        ek, ep, ulp, rk, rp, close = float64_referee(got_l, ref_l, exact)
        log(f"[referee] [{label}] logits: the gate is exceeded ({ratio:.3f}); against the fp32 plain path on the same "
            f"weights: max error kernel path {ek:.4g}, plain path {ep:.4g}, one bf16 ulp at the kernel's worst element "
            f"{ulp:.4g}; rms error kernel {rk:.4g}, plain {rp:.4g} | {'passes' if close else 'FAILS'} (kernel <= "
            "(1 + 2^-3) plain + 1 ulp, rms <= (1 + 2^-3) plain's)")
    if (div is not None and not div[1] <= NEAR_TIE) or not (torch.isfinite(got_l).all() and close):
        raise AssertionError(f"[{label}] the kernel path departs from the plain path: ids {got} vs {ref}, logits "
                             f"worst err/tol {ratio}")
    del hc

    opt = build_optimizer(model, learning_rate=1e-3, guide_injector_lr=1e-3, total_steps=HD256_STEPS,
                          tunable_parts="mm_projector", use_guide="direct")
    state = create_train_state(model, opt, device=DEVICE)
    params = dict(model.named_parameters())
    trained = sorted(n for n, p in params.items() if p.requires_grad)
    frozen_before = bit_sums((n, p) for n, p in params.items() if n not in trained)
    trained_before = {n: params[n].detach().clone() for n in trained}
    tbatch = batch_to_device(make_train_batch(cfg), torch.device(DEVICE), torch.bfloat16)

    def grads():
        return {n: params[n].grad.detach().float() if params[n].grad is not None else
                torch.zeros_like(params[n], dtype=torch.float32) for n in trained}

    with plain_path():  # step 1's gradients on the plain path, from the same weights
        loss_p, _ = make_loss_fn(model)(tbatch)
        loss_p.backward()
    plain = grads()
    for p in model.parameters():
        p.grad = None
    step = make_train_step()
    reset_counts()
    times, metrics, fwd, per_step = run_steps(state, step, tbatch, n=1)
    got_g = grads()
    noise = 2**-16 * max(float(g.abs().max()) for g in plain.values())
    cancelled = [n for n in trained if float(plain[n].abs().max()) <= noise]
    loud = [n for n in cancelled if float(got_g[n].abs().max()) > noise]
    rel = {n: float((got_g[n] - plain[n]).norm()) / float(plain[n].norm()) for n in trained if n not in cancelled}
    worst = max((r, n) for n, r in rel.items())
    log(f"[{label}] step 1's gradients, kernel vs plain path: loss {metrics[0]['loss']:.6f} vs "
        f"{float(loss_p.detach()):.6f}, {len(trained)} tensors, worst |diff| / |plain| {worst[0]:.4g} ({worst[1]}; "
        f"tol 0.05 of each tensor's norm); {len(cancelled)} cancelled tensors below {noise:.3g} on both paths: "
        f"{'yes' if not loud else loud}")
    if loud or not worst[0] <= 0.05:
        raise AssertionError(f"[{label}] kernel-path gradients depart from the plain path's: {worst}, {loud}")
    del plain, got_g, loss_p
    more = run_steps(state, step, tbatch, n=HD256_STEPS - 1)
    times, metrics, fwd, per_step = (a + b for a, b in zip((times, metrics, fwd, per_step), more))
    with_grad = [n for n in trained if params[n].grad is not None and params[n].grad.abs().max().item() >= 1e-8]
    trained_launches = log_steps(label, card, f"HICom-7B (heads of {tc.head_dim}, {layers} layers) stage 2", model, cfg,
                                 tbatch, times, metrics, fwd, per_step)
    bwd_sources = {key: n for key, n in source_launches.items() if key[0][:2] in ("K5", "K6")}
    log(f"[{label}] flash backward by kernel and library {bwd_sources}")
    if per_step != [layers + 1] * HD256_STEPS:  # every decoder layer (wide) + the global compressor (d 128)
        raise AssertionError(f"[{label}] flash backward launched {per_step} times per step, not {layers + 1}")
    after = bit_sums((n, params[n]) for n in frozen_before)
    changed = [n for n in frozen_before if not torch.equal(after[n], frozen_before[n])]
    still = [n for n in with_grad if torch.equal(params[n].detach(), trained_before[n])]
    if changed or still or not with_grad:
        raise AssertionError(f"[{label}] frozen tensors changed {changed[:3]}; trained tensors with a gradient that "
                             f"did not move {still[:3]} (of {len(with_grad)})")
    log(f"[{label}] checks: {len(frozen_before)} frozen tensors kept their bits; {len(with_grad)} of {len(trained)} "
        f"trained tensors had a gradient >= AdamW's eps (1e-8) and all moved")
    del model, state, opt, params, trained_before, tbatch
    torch.cuda.empty_cache()
    return {**launches, "flash_backward": trained_launches["flash_backward"], **fwd_sources, **bwd_sources}


# ---------------------------------------------------------------------------
# The continuous-batching engine at HICom-7B: [serve-engine]
# ---------------------------------------------------------------------------

ENGINE = dict(n_slots=4, cache_len=4096, sync_steps=16, prompt_buckets=(64, 128, 256, 512))
# what [serve-engine] leaves for [mesh-serve]: its requests, graphed streams, tokenizer and readings
ENGINE_REFERENCE = {}
ENGINE_BUDGETS = (32, 8, 24, 16, 12, 28, 20, 10)  # max_new_tokens of the phase's 8 requests
NEAR_TIE = 2**-6  # a divergence is allowed where the standalone run's top-2 gap is at most this of |top logit|


def engine_samples(cfg, seed: int = 40):
    """The phase's 8 ``mm_serve`` samples: 5 videos of ``cfg.num_frames``
    frames, 1 single-frame image and 2 text prompts, each with a distinct
    seeded instruction of 20-99 words (prompts in the 64 and 128 buckets),
    full-length guide ids and a budget in 8-32."""
    rng = np.random.default_rng(seed)
    size, gcfg = cfg.vision_config.image_size, cfg.guide_text_config
    samples = []
    for i, budget in enumerate(ENGINE_BUDGETS):
        words = " ".join(f"q{int(w)}" for w in rng.integers(0, 10**6, int(rng.integers(20, 100))))
        s = dict(instruct=words, max_new_tokens=budget)
        if i < 6:
            t = cfg.num_frames if i < 5 else 1
            s.update(tensor=rng.uniform(-1, 1, (t, 3, size, size)).astype(np.float32),
                     modal="video" if i < 5 else "image",
                     guide_ids=rng.integers(0, gcfg.vocab_size, gcfg.max_position_embeddings))
        samples.append(s)
    return samples


def stop_word(tok, ids) -> str:
    """A string the ``WordTokenizer`` turns into exactly ``ids``: one
    character per word whose code point hashes to the id."""
    words = []
    for i in ids:
        c = i - 3
        while chr(c).isspace() or 0xD800 <= c <= 0xDFFF or c < 33:
            c += tok.vocab - 3
        words.append(chr(c))
    return " ".join(words)


def trim_stream(toks, eos, stops):
    """A standalone ``generate`` row as the engine returns it: cut at eos and
    before the first occurrence of a stop sequence."""
    toks = list(toks)
    toks = toks[:toks.index(eos)] if eos in toks else toks
    for seq in stops:
        for i in range(len(toks) - len(seq) + 1):
            if tuple(toks[i:i + len(seq)]) == tuple(seq):
                toks = toks[:i]
                break
    return toks


def standalone(hc, eng, req):
    """``HICom.generate`` of one request alone (greedy), its prompt padded to
    the engine's bucket with a mask as the engine pads it; returns the stream
    as the engine would return it and each step's top-2 logits (steps, 2)."""
    L = len(req.input_ids)
    bucket = eng._bucket_for(L)
    ids = np.full((1, bucket), eng.pad_token_id, np.int64)
    ids[0, :L] = req.input_ids
    mask = np.zeros((1, bucket), bool)
    mask[0, :L] = True
    row, tops = greedy_with_tops(hc, dict(input_ids=ids, frames=None if req.frames is None else req.frames[None],
                                          guide_ids=None if req.guide_ids is None else req.guide_ids[None],
                                          attention_mask=mask, modal=req.modal, stop_sequences=req.stop_sequences),
                                 req.max_new_tokens)
    return trim_stream(row, hc.eos_token_id, req.stop_sequences), tops


def first_divergence(got, ref, tops):
    """None where the streams are equal, else (position, top-2 gap over
    |top logit| of the standalone run there)."""
    if got == ref:
        return None
    j = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), min(len(got), len(ref)))
    top1, top2 = tops[min(j, len(tops) - 1)].tolist()
    return j, (top1 - top2) / abs(top1)


def drive(eng, reqs):
    """Submit ``reqs``, run the engine round by round. Returns (streams,
    results, wall seconds, [(round seconds, admissions)])."""
    import torch

    torch.cuda.synchronize()
    ids = [eng.submit(r) for r in reqs]
    rounds = []
    t0 = time.perf_counter()
    while not eng.idle:
        queued = len(eng._queue)
        r0 = time.perf_counter()
        eng.step_round()
        rounds.append((time.perf_counter() - r0, queued - len(eng._queue)))
    wall = time.perf_counter() - t0
    res = eng.run()
    return [res[i].tokens.tolist() for i in ids], [res[i] for i in ids], wall, rounds


def engine_line(label, card, streams, results, wall, rounds, phase="serve-engine"):
    n_tok = sum(map(len, streams))
    ttft = " ".join(f"{1e3 * r.first_token_s:.0f}" for r in results)
    log(f"[{phase}] {label}: {card} | {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s aggregate | "
        f"{len(rounds)} rounds, admissions in them {[adm for _, adm in rounds]} | submit-to-first-token ms per "
        f"request: {ttft}")
    return n_tok / wall


def round_idle(eng, reqs):
    """One decode round with every slot resident, timed on the host (the
    third round of 4 requests: admissions and, graphed, the capture come
    before it), then the device's idle share of the next one under
    torch.profiler, with CUDA events around it. Returns (round ms, profiled
    round ms, device kernel ms, event ms), or None when the requests ended
    too soon."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for r in reqs:
        eng.submit(r)
    eng.step_round()
    eng.step_round()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step_round()
    round_ms = 1e3 * (time.perf_counter() - t0)
    if eng.idle:
        return None
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        eng.step_round()
        end.record()
        wall = time.perf_counter() - t0
    end.synchronize()
    eng.run()
    busy_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return round_ms, 1e3 * wall, busy_ms, start.elapsed_time(end)


def norms_at_one(model):
    """The decoder's norm weights at their usual initial value, 1: with
    build_model's N(0, 0.02) draw every request decodes one token over and
    over, which would leave a comparison of streams nothing to tell apart."""
    import torch

    from hicom_tpu_torch.models.qwen2 import RMSNorm

    with torch.no_grad():
        for m in model.model.modules():
            if isinstance(m, RMSNorm):
                m.weight.fill_(1.0)


def serve_engine_phase(card: str, hc):
    """Phase 4c, on ``[slice]``'s HICom-7B (its decoder norms set to 1):
    ``mm_serve``'s engine (4 slots, a 4,096-slot cache, 16 steps a round,
    buckets 64-512) takes 8 requests (5 videos of 32 frames, an image, 2
    text prompts; budgets 8-32, so slots free up and refill mid-run; every
    request carries one stop sequence, which one standalone stream holds)
    eagerly, with graphed rounds, with graphed rounds and ``spec_k=3``
    (adaptive, and forced on every round), each graphed engine twice (the
    first pass captures), and through ``mm_serve`` itself. Gates: graphed
    streams equal eager ones bit for bit; speculative ones equal plain ones;
    each stream equals the request's standalone ``HICom.generate``; a stream
    may part from its reference only where the standalone run's top-2 logit
    gap is at most 2^-6 of its top logit; one admission and one graphed
    round under ``set_sync_debug_mode("error")``; K1-K4 launched (K3 counted
    per replay). Returns the phase's launches by wrapper."""
    import torch

    from hicom_tpu_torch.api import _trim_at_keywords, mm_serve, serve_engine, serve_request
    from hicom_tpu_torch.serve import ServeEngine

    cfg = hc.config
    tok = WordTokenizer(cfg.text_config.vocab_size, cfg.guide_text_config.max_position_embeddings)
    eos = hc.eos_token_id
    norms_at_one(hc.model)
    fns = counters()
    for f in fns.values():
        f.launches = 0
    cap0, rep0 = ServeEngine.k3_captured, ServeEngine.k3_replayed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    samples = engine_samples(cfg)
    probe = serve_engine(hc, tok, cuda_graphs=False, **ENGINE)
    reqs = [serve_request(s, hc, tok, guide_len=probe.guide_len) for s in samples]
    # each request alone, greedy, without a stop; the stop sequence is the
    # first pair of tokens, from a stream's 4th token on, that does not occur
    # earlier in its stream (a pair no stream holds if there is none), and
    # every request carries it, as mm_serve gives its stop strings to all.
    # HICom.generate with a stop ends its row at the stop sequence, which the
    # engine cuts off: trim_stream applies the same cut to each plain stream
    plain = [standalone(hc, probe, r) for r in reqs]
    pick = next(([t[j], t[j + 1]] for t, _ in plain for j in range(3, len(t) - 1)
                 if all(t[i:i + 2] != t[j:j + 2] for i in range(j))), None)
    if pick is None:
        held = {x for t, _ in plain for x in t}
        pick = [x for x in range(3, tok.vocab) if x not in held][:2]
    stop = stop_word(tok, pick)
    stops = (tuple(tok(stop).input_ids),)
    for r in reqs:
        r.stop_sequences = stops
    alone = [(trim_stream(t, eos, stops), tops) for t, tops in plain]
    shapes = [(r.modal, len(r.input_ids), r.max_new_tokens) for r in reqs]
    log(f"[serve-engine] 8 requests (modal, prompt ids, budget): {shapes} | stop sequence {stops[0]} | standalone streams of {[len(t) for t, _ in plain]} tokens, "
        f"{[len(a) for a, _ in alone]} after the stop; the first 12 of each: {[t[:12] for t, _ in plain]}")

    eager, eres, ewall, erounds = drive(probe, reqs)
    eager_tps = engine_line("eager", card, eager, eres, ewall, erounds)
    graphed_eng = serve_engine(hc, tok, cuda_graphs=True, **ENGINE)
    g1 = drive(graphed_eng, reqs)
    graphed, gres, gwall, grounds = drive(graphed_eng, reqs)
    first_tps = engine_line("graphed, first pass (captures)", card, *g1)
    graphed_tps = engine_line("graphed", card, graphed, gres, gwall, grounds)
    spec_eng = serve_engine(hc, tok, spec_k=3, **ENGINE)
    s1 = drive(spec_eng, reqs)
    spec, sres, swall, srounds = drive(spec_eng, reqs)
    engine_line("graphed, spec_k=3, first pass (captures)", card, *s1)
    spec_tps = engine_line("graphed, spec_k=3", card, spec, sres, swall, srounds)
    # the adaptive policy speculates only with one slot resident, which this
    # set may never reach: the forced arm (JAX's spec_adaptive=False) runs
    # every round speculatively, 4 slots x 4 tokens a verify step
    forced_eng = ServeEngine(hc.model, spec_k=3, spec_adaptive=False, eos_token_id=eos, guide_len=probe.guide_len,
                             device=hc.device, **ENGINE)
    f1 = drive(forced_eng, reqs)
    forced, fres, fwall, frounds = drive(forced_eng, reqs)
    engine_line("graphed, spec_k=3 forced, first pass (captures)", card, *f1)
    forced_tps = engine_line("graphed, spec_k=3 forced", card, forced, fres, fwall, frounds)
    for label, eng in (("spec_k=3", spec_eng), ("spec_k=3 forced", forced_eng)):
        log(f"[serve-engine] {label}: acceptance EMA {eng._accept_ema}, spec_rounds {eng.spec_rounds}, plain_rounds "
            f"{eng.plain_rounds} over both passes | K3 launches a captured round {eng.graph_launches}, replays "
            f"{eng.replays}")
    log(f"[serve-engine] plain graphs: K3 launches a captured round {graphed_eng.graph_launches}, replays "
        f"{graphed_eng.replays}")
    texts = mm_serve(samples, hc, tok, stop_strings=[stop], **ENGINE)
    eos_str = tok.decode([eos])
    want = [_trim_at_keywords(tok.decode(e).strip(), [eos_str, stop]) for e in eager]

    # gates 1-3
    if graphed != eager or g1[0] != eager:
        raise AssertionError(f"[serve-engine] graphed streams differ from eager ones: {graphed} vs {eager}")
    if texts != want:
        raise AssertionError(f"[serve-engine] mm_serve's strings differ from the engine's: {texts} vs {want}")
    if s1[0] != spec or f1[0] != forced:
        raise AssertionError("[serve-engine] a speculative engine's two passes differ")
    for label, streams in (("spec_k=3 vs plain", spec), ("spec_k=3 forced vs plain", forced),
                           ("engine vs standalone generate", graphed)):
        for i, (got, (ref, tops)) in enumerate(zip(streams, alone)):
            base = ref
            if label.startswith("spec"):
                # held to the plain stream; the standalone run's logits judge a
                # tie where that stream still follows the standalone one
                base = graphed[i]
                j = next((k for k, (a, b) in enumerate(zip(got, base)) if a != b), min(len(got), len(base)))
                if graphed[i][:j + 1] != ref[:j + 1]:
                    base = ref
            div = first_divergence(got, base, tops)
            if div is None:
                continue
            j, gap = div
            log(f"[serve-engine] {label}: request {i} parts at token {j}, standalone top-2 gap {gap:.3g} of "
                f"|top logit| (allowed {NEAR_TIE:.3g})")
            if not gap <= NEAR_TIE:
                raise AssertionError(f"[serve-engine] {label}: request {i} diverges at token {j} off a near-tie")
    log(f"[serve-engine] graphed == eager bit for bit (both graphed passes); mm_serve strings == the engine's; "
        f"spec == plain for {sum(a == b for a, b in zip(spec, graphed))} of 8 requests, forced spec == plain for "
        f"{sum(a == b for a, b in zip(forced, graphed))} of 8, engine == standalone for "
        f"{sum(a == b for a, b in zip(graphed, (r for r, _ in alone)))} of 8")

    # gate 4: one admission and one graphed round without a synchronising call
    sync_eng = graphed_eng
    sync_eng.submit(reqs[0])
    torch.cuda.synchronize()
    replays = dict(sync_eng.replays)
    torch.cuda.set_sync_debug_mode("error")
    try:
        kind = sync_eng.dispatch_round()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if sync_eng.replays.get(kind) != replays.get(kind, -1) + 1:
        raise AssertionError(f"[serve-engine] the checked round did not replay a graph ({kind})")
    sync_eng.collect_round(kind)
    sync_eng.run()
    log(f"[sync] one admission (32-frame video: upload, guide encoder, tower, projector, prefill, first token, "
        f"slot scatter) and one graphed {kind} round under set_sync_debug_mode('error'): no synchronising call")

    # idle share of a decode round with 4 resident slots, eager and graphed
    prof_reqs = [serve_request(dict(instruct=f"q{i} " * 30, max_new_tokens=80), hc, tok) for i in range(4)]
    rounds = {}
    for label, eng in (("eager", probe), ("graphed", graphed_eng)):
        idle = round_idle(eng, prof_reqs)
        if idle is None:
            log(f"[serve-engine] {label} decode round: not measured (every request ended within three rounds)")
            continue
        round_ms, wall, busy, span = rounds[label] = idle
        steps = ENGINE["sync_steps"]
        log(f"[serve-engine] {label} decode round, 4 slots resident: {round_ms:.1f} ms ({round_ms / steps:.2f} ms a "
            f"step, {4 * steps / round_ms * 1e3:.1f} tokens/s) | the next under torch.profiler: wall {wall:.1f} ms, "
            f"device kernels {busy:.1f} ms, events {span:.1f} ms, idle share {1 - busy / wall:.3f}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    ENGINE_REFERENCE.update(reqs=reqs, streams=graphed, tok=tok, prof_reqs=prof_reqs, peak_gb=peak,
                            first_pass_tokens_per_s=first_tps,
                            round_ms=rounds["graphed"][0] if "graphed" in rounds else None)

    launches = {name: f.launches for name, f in fns.items()}
    captured, replayed = ServeEngine.k3_captured - cap0, ServeEngine.k3_replayed - rep0
    launches["flash_decode"] += replayed - captured
    log(f"[serve-engine] launches: {launches} (K3: {replayed} by replays, {captured} capture calls taken out) | "
        f"aggregate tokens/s eager {eager_tps:.1f}, graphed {graphed_tps:.1f}, spec {spec_tps:.1f}, forced spec "
        f"{forced_tps:.1f} | decode round ms {({k: round(v[0], 1) for k, v in rounds.items()})} | peak memory "
        f"{peak:.2f} GB | phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if min(launches.values()) <= 0 or replayed <= 0:
        raise AssertionError(f"[serve-engine] K1-K4 not all launched: {launches}, K3 by replays {replayed}")
    del probe, graphed_eng, spec_eng, forced_eng, sync_eng
    torch.cuda.empty_cache()
    return launches


def projector_sync_check(model, single):
    """Phase 4b: one serving forward of the projector (``model.model.mm_projector``)
    on the single request's tower features, under
    ``torch.cuda.set_sync_debug_mode("error")``: a call that waits for the device
    (a blocking copy from the host, a read of a device value) raises. The
    forward must launch K4 once and give finite visual tokens."""
    import torch

    from hicom_tpu_torch.ops.local_attn import fused_tile_attention

    dev = DEVICE
    with torch.inference_mode():
        frames = torch.as_tensor(single["frames"], device=dev, dtype=torch.bfloat16)
        ge = model.encode_guide(torch.as_tensor(single["guide_ids"], device=dev))
        b, t = frames.shape[:2]
        feats, embeds = model.model.vision_tower.vision_tower(frames.reshape((b * t,) + frames.shape[2:]))
        feats, embeds = feats.reshape((b, t) + feats.shape[1:]), embeds.reshape((b, t) + embeds.shape[1:])
        torch.cuda.synchronize()
        before = fused_tile_attention.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            vis = model.model.mm_projector(feats, embeds, ge, "video")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launched = fused_tile_attention.launches - before
        finite = bool(torch.isfinite(vis).all())
    log(f"[sync] projector forward {tuple(vis.shape)} under set_sync_debug_mode('error'): no synchronising call, "
        f"K4 launches {launched}, finite {finite}")
    if launched != 1 or not finite:
        raise AssertionError(f"the projector forward launched K4 {launched} times (1 expected), finite {finite}")


def video_front(hc, single, frames_fn=None):
    """The stages of a video request up to the projector, as a ``front`` of
    :func:`stage_breakdown`: the upload of ``single["frames"]`` (or the frames
    ``frames_fn()`` makes: the uint8 upload and the device preprocess) and
    the guide encoder, the vision tower, the projector."""
    import torch

    model, dev = hc.model, hc.device
    dtype = model.model.norm.weight.dtype

    def front(mark):
        ids = torch.as_tensor(single["input_ids"], device=dev)
        if frames_fn is None:
            frames = torch.as_tensor(single["frames"], device=dev, dtype=dtype)
        else:
            frames = frames_fn()
        ge = model.encode_guide(torch.as_tensor(single["guide_ids"], device=dev))
        mark("upload + guide encoder" if frames_fn is None else "uint8 upload + preprocess + guide encoder")
        b, t = frames.shape[:2]
        feats, embeds = model.model.vision_tower.vision_tower(frames.reshape((b * t,) + frames.shape[2:]))
        mark("vision tower")
        vis = model.model.mm_projector(feats.reshape((b, t) + feats.shape[1:]),
                                       embeds.reshape((b, t) + embeds.shape[1:]), ge, "video")
        mark("projector")
        return ids, vis

    return front


def stage_breakdown(hc, front, new_tokens: int = 16, label: str = "stages"):
    """Phase 4a: one request again, stage by stage (host clock around
    synchronised stages), then under torch.profiler: device kernel time by
    kernel and the device's idle share of the request's wall time.
    ``front(mark) -> (ids, visual tokens)`` runs the stages up to the
    projector (:func:`video_front`, or the anyres image's), calling ``mark``
    after each. Returns the decode rate of one request, (new_tokens - 1) over
    the time from its first token to its last, and {stage: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hicom_tpu_torch.models.generate import sample_and_loop
    from hicom_tpu_torch.models.qwen2 import KVCache

    model, cfg, dev = hc.model, hc.config, hc.device
    tc = cfg.text_config

    @torch.inference_mode()
    def request(stamps):
        def mark(name):
            torch.cuda.synchronize()
            stamps.append((name, time.perf_counter()))

        mark("start")
        ids, vis = front(mark)
        sp = model.embed_and_splice(ids, vis)
        b = ids.shape[0]
        cache = KVCache.zeros(tc.num_hidden_layers, b, tc.num_key_value_heads,
                              hc.cache_len_for(ids.shape[1], vis.shape[1], new_tokens), tc.head_dim,
                              model.model.norm.weight.dtype, dev)
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
    stages = {n: 1e3 * (t - stamps[i][1]) for i, (n, t) in enumerate(stamps[1:])}
    log(f"[{label}] " + " | ".join(f"{n} {ms:.1f} ms" for n, ms in stages.items()))
    decode_tps = (new_tokens - 1) / (stamps[-1][1] - stamps[-2][1])

    stamps = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        request(stamps)
    wall_us = 1e6 * (stamps[-1][1] - stamps[0][1])
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy_us = sum(dev_time(e) for e in kernels)
    tag = "profile" if label == "stages" else f"{label}-profile"
    if busy_us <= 0:
        log(f"[{tag}] the profiler saw no device time")
        return decode_tps, stages
    log(f"[{tag}] request wall {wall_us / 1e3:.1f} ms, device kernels {busy_us / 1e3:.1f} ms, "
        f"idle share {1 - busy_us / wall_us:.3f}")
    for e in sorted(kernels, key=dev_time, reverse=True)[:10]:
        log(f"[{tag}]   {dev_time(e) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    return decode_tps, stages


def run_steps(state, step, batch, n: int = TRAIN_STEPS):
    """``n`` train steps, each timed on the host clock around a synchronised
    step, with each step's flash forward and backward launches. Returns
    (seconds, metrics, forward launches, backward launches), one per step."""
    import torch

    fns = counters(train=True)
    times, metrics, fwd, bwd = [], [], [], []
    for _ in range(n):
        f0, b0 = fns["flash_forward"].launches, fns["flash_backward"].launches
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        fwd.append(fns["flash_forward"].launches - f0)
        bwd.append(fns["flash_backward"].launches - b0)
        metrics.append({k: float(v) for k, v in m.items()})
    return times, metrics, fwd, bwd


def reset_counts():
    import torch

    from hicom_tpu_torch.ops.flash_attention import source_launches

    for f in counters(train=True).values():
        f.launches = 0
    source_launches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def log_steps(label: str, card: str, what: str, model, cfg, batch, times, metrics, fwd, bwd, spliced=None,
              inputs=None):
    """The per-step lines and the phase's summary line: step ms (mean of
    steps 2 on), target and spliced tokens/s, peak memory. ``spliced``: the
    batch's spliced tokens (default: a video of ``cfg.num_frames`` frames per
    row), ``inputs`` what a row carries. Fails on a non-finite loss."""
    import torch

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: f.launches for name, f in counters(train=True).items()}
    log(f"[{label}] launches over {len(times)} steps: {launches}; flash_forward per step {fwd}, "
        f"flash_backward per step {bwd}")
    for i, m in enumerate(metrics):
        log(f"[{label}] step {i + 1}: " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()) + f", {times[i] * 1e3:.1f} ms")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"[{label}] non-finite metrics: {metrics}")
    if spliced is None:
        spliced = batch["input_ids"].shape[0] * (batch["input_ids"].shape[1] - 1 + model.visual_token_count(
            cfg.num_frames, "video"))
    steady = sum(times[1:]) / len(times[1:])
    targets = metrics[-1]["target_tokens"]
    log(f"[{label}] {card} | {what}, batch 2 x {inputs or f'{cfg.num_frames} frames'}, {spliced} spliced tokens, "
        f"{int(targets)} "
        f"target tokens | step {steady * 1e3:.1f} ms (mean of steps 2-{len(times)}; step 1 {times[0] * 1e3:.1f} ms) | "
        f"{targets / steady:.1f} target tokens/s | {spliced / steady:.1f} spliced tokens/s | peak memory "
        f"{peak_gb:.2f} GB")
    return launches


def train_phase(card: str):
    """Phase 5: stage 2 of the reference's recipe (``--use-guide direct
    --mm-tunable-parts mm_projector --guide-injector-lr 1e-3``) at the full
    width of HICom-7B: 3 train steps on a seeded batch of 2 (prompts of 64 and
    41 tokens, 32-frame videos, 743 spliced tokens per row). Returns the flash
    backward's launches over the 3 steps."""
    import torch

    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.train.optimizer import build_optimizer, trainable_param_count
    from hicom_tpu_torch.train.train_step import batch_to_device, create_train_state, make_train_step

    cfg = serving_config()
    model = build_model(cfg, device="cuda", seed=0)
    # total_steps counts the staged and profiled steps too; no warmup (int(5 * 0.03) = 0)
    opt = build_optimizer(model, learning_rate=1e-3, guide_injector_lr=1e-3, total_steps=TRAIN_STEPS + 2,
                          tunable_parts="mm_projector", use_guide="direct")
    state = create_train_state(model, opt)
    params = dict(model.named_parameters())
    trained = {n for n, p in params.items() if p.requires_grad}
    log(f"[train] stage 2: {trainable_param_count(model, 'mm_projector', 'direct') / 1e6:.1f} M trained "
        f"parameters (fp32 masters), {sum(p.numel() for n, p in params.items() if n not in trained) / 1e9:.2f} B "
        "frozen (bf16)")
    frozen_before = bit_sums((n, p) for n, p in params.items() if n not in trained)
    trained_before = {n: params[n].detach().clone() for n in trained}
    batch = batch_to_device(make_train_batch(cfg), torch.device("cuda"), torch.bfloat16)
    step = make_train_step()

    reset_counts()
    times, metrics, fwd, per_step = run_steps(state, step, batch)
    with_grad = {n for n in trained if params[n].grad is not None and bool(params[n].grad.any())}
    launches = log_steps("train", card, "HICom-7B stage 2", model, cfg, batch, times, metrics, fwd, per_step)

    n_layers = cfg.text_config.num_hidden_layers
    if per_step != [n_layers + 1] * TRAIN_STEPS:  # every decoder layer + the global compressor
        raise AssertionError(f"flash backward launched {per_step} times per step, not {n_layers + 1}")
    if launches["fused_tile_attention"] or launches["flash_decode"]:
        raise AssertionError(f"a kernel without a backward ran in training: {launches}")
    if not (launches["fullblock_attention"] and launches["flash_forward"]):
        raise AssertionError(f"the train step never launched a forward kernel: {launches}")
    after = bit_sums((n, params[n]) for n in frozen_before)
    changed = [n for n, before in frozen_before.items() if not torch.equal(after[n], before)]
    if changed:
        raise AssertionError(f"{len(changed)} frozen parameters changed, e.g. {changed[:3]}")
    still = [n for n in with_grad if torch.equal(params[n].detach(), trained_before[n])]
    if still or not with_grad:
        raise AssertionError(f"trained parameters with a nonzero gradient did not move: {still[:5]}")
    log(f"[train] checks: {len(frozen_before)} frozen tensors kept their bits; {len(with_grad)} of {len(trained)} "
        f"trained tensors had a nonzero gradient and all moved")
    train_profile("train", state, step, batch, model.parameters(), lambda: state.optimizer.update(model))
    del model, state, opt, params, trained_before, batch
    torch.cuda.empty_cache()
    return launches, {"metrics": metrics, "step_ms": sum(times[1:]) / len(times[1:]) * 1e3}


def mesh_env(port: int):
    """``torchrun``'s environment for a one-rank group on ``port``: set while
    inside, the caller's restored after."""
    import os

    keys = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}

    @contextmanager
    def env():
        saved = {k: os.environ.get(k) for k in keys}
        os.environ.update(keys)
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    return env()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_train_phase(card: str, want: dict):
    """[mesh-train]: [train]'s 3 stage-2 steps of HICom-7B (full width and
    depth, the same seeded weights and batch) through the mesh path in a
    one-rank NCCL group: ``init_distributed`` (from torchrun's environment),
    ``create_mesh(1, 1, 1)``, ``create_sharded_state`` (the rules' tp plan by
    ``parallelize_module`` over a one-rank tp mesh, FSDP2 ``fully_shard`` of
    every layer and the root, the optimizer over the local shards). At world
    size 1 the collectives copy and the DTensor layers run the plain layers'
    local ops, so the losses, target tokens and grad norms must equal
    [train]'s bit for bit. The attention must reach K1/K2/K5/K6 as plain
    local tensors (a DTensor raises in the wrappers): flash_backward once per
    decoder layer and the global compressor each step, as in [train]; the
    frozen tensors keep their bits. The step time beside [train]'s is
    the cost of the DTensor/FSDP2 machinery at world size 1, not a claim."""
    import torch
    import torch.distributed as dist

    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.parallel.mesh import create_mesh, init_distributed
    from hicom_tpu_torch.parallel.sharding import local
    from hicom_tpu_torch.train.optimizer import build_optimizer
    from hicom_tpu_torch.train.train_step import batch_to_device, create_sharded_state, make_train_step

    cfg = serving_config()
    with mesh_env(free_port()):
        device = init_distributed("cuda", 1, 1, 1)
        try:
            mesh = create_mesh(1, 1, 1)
            log(f"[mesh-train] {dist.get_backend()} group of {dist.get_world_size()} on {device}, mesh "
                f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
            model = build_model(cfg, device="cuda", seed=0)
            opt = build_optimizer(model, learning_rate=1e-3, guide_injector_lr=1e-3, total_steps=TRAIN_STEPS + 2,
                                  tunable_parts="mm_projector", use_guide="direct")
            trained = {n for n, lab in opt.labels.items() if lab != "frozen"}
            frozen_before = bit_sums((n, p) for n, p in model.named_parameters() if n not in trained)
            t0 = time.perf_counter()
            state = create_sharded_state(model, opt, mesh, device)
            torch.cuda.synchronize()
            shard_s = time.perf_counter() - t0
            params = dict(model.named_parameters())
            kinds = {type(p).__name__ for p in params.values()}
            split = sorted({n.rsplit(".", 1)[0].split(".")[-1] for n, p in params.items()
                            if any(pl.is_shard() for pl in getattr(p, "placements", ())[2:])})
            batch = batch_to_device(make_train_batch(cfg), device, torch.bfloat16)
            reset_counts()
            times, metrics, fwd, per_step = run_steps(state, make_train_step(), batch)
            launches = log_steps("mesh-train", card, "HICom-7B stage 2 through the (1, 1, 1) mesh", model, cfg,
                                 batch, times, metrics, fwd, per_step)
            after = bit_sums((n, local(params[n])) for n in frozen_before)
            moved = [n for n in frozen_before if not torch.equal(after[n], frozen_before[n])]
            step_ms = sum(times[1:]) / len(times[1:]) * 1e3
            keys = ("loss", "target_tokens", "grad_norm")
            diff = {k: [abs(m[k] - w[k]) for m, w in zip(metrics, want["metrics"])] for k in keys}
            log(f"[mesh-train] {card} | parameters {sorted(kinds)}, tp-planned modules {split}, sharded in "
                f"{shard_s:.1f} s | step {step_ms:.1f} ms against [train]'s {want['step_ms']:.1f} ms "
                f"({step_ms / want['step_ms']:.3f}x: the DTensor/FSDP2 machinery at world size 1) | |mesh - train| "
                f"per step: {diff}")
            n_layers = cfg.text_config.num_hidden_layers
            if per_step != [n_layers + 1] * TRAIN_STEPS or not (launches["fullblock_attention"]
                                                                and launches["flash_forward"]):
                raise AssertionError(f"[mesh-train] kernels: flash_backward per step {per_step}, launches {launches}")
            if kinds != {"DTensor"}:
                raise AssertionError(f"[mesh-train] the model was not sharded: parameter types {kinds}")
            if any(d for v in diff.values() for d in v):
                raise AssertionError(f"[mesh-train] the mesh path's steps differ from [train]'s: {diff}")
            if moved:
                raise AssertionError(f"[mesh-train] {len(moved)} frozen tensors moved, e.g. {moved[:3]}")
            log(f"[mesh-train] checks: losses, target tokens and grad norms of {TRAIN_STEPS} steps bit-equal to "
                f"[train]'s; {len(frozen_before)} frozen tensors kept their bits")
            # where the extra time goes: the sharded tower has no forward of its own outside the step
            train_profile("mesh-train", state, make_train_step(), batch, model.parameters(), None, stages=False)
            del model, state, opt, params, batch
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Sequence-parallel inference at HICom-7B: [seq-parallel]
# ---------------------------------------------------------------------------

LONG_VIDEO_FRAMES = 128  # beyond the reference's 32-frame cap
LONG_VIDEO_RANKS = 4  # the run whose ranks' shares [long-video] runs in turn
RING_TOKENS = 16384  # HICOM_RING_PREFILL_MIN's default
RING_RANKS = 8  # the ring whose ranks' blocks [ring-prefill] runs in turn


def seq_counters():
    """The kernel wrappers of the sequence-parallel paths, the merge kernel's too."""
    from hicom_tpu_torch.ops.flash_attention import merge_partials

    return {**counters(), "merge_partials": merge_partials}


def zero_counts(fns):
    for f in fns.values():
        f.launches = 0


def long_video(cfg, seed: int = 50):
    """A seeded 128-frame video at the tower's size and full-length guide ids."""
    rng = np.random.default_rng(seed)
    size, gcfg = cfg.vision_config.image_size, cfg.guide_text_config
    frames = rng.uniform(-1, 1, (LONG_VIDEO_FRAMES, 3, size, size)).astype(np.float32)
    return frames, rng.integers(0, gcfg.vocab_size, (1, gcfg.max_position_embeddings))


@contextmanager
def ranks_in_turn():
    """Stand in, in this process, for the ranks of one run taken in turn: the
    global compressor's gather (``ops.attention.gather_partials``) records each
    chunk's K2 partials and returns them alone; once ``state["all"]`` is set
    it returns every recorded chunk's, in rank order, to the one merge."""
    import torch

    from hicom_tpu_torch.ops import attention

    state = {"parts": [], "all": False}

    def gather(parts, group):
        if state["all"]:
            return tuple(torch.cat(t) for t in zip(*state["parts"]))
        state["parts"].append(parts)
        return parts

    original, attention.gather_partials = attention.gather_partials, gather
    try:
        yield state
    finally:
        attention.gather_partials = original


def long_video_phase(card: str, hc) -> dict:
    """[long-video]: a 128-frame 384x384 video through ``HICom.encode_long_video``
    (the frames split over the one rank), held to ``encode_visual`` over the
    same frames. Then each rank's share of a 4-rank run: ``encode_visual_shard``
    on 32 frames at offsets 0, 32, 64 and 96 in turn, the local grids
    concatenated and the global compressor's partials merged by the merge
    kernel inside ``sdpa(..., kv_group=)``, held to the same single pass
    within the gate over the whole output. K1, K2, K4 and the merge kernel
    must launch. Returns the launches of ``encode_long_video``."""
    import torch

    from hicom_tpu_torch.models.postprocess import post_process_visual_feature
    from hicom_tpu_torch.ops.attention import SoloGroup
    from hicom_tpu_torch.parallel.mesh import world_mesh

    cfg, model = hc.config, hc.model
    frames, gids = long_video(cfg)
    world_mesh()  # set-up: the mesh's process groups are made once
    fns = seq_counters()
    zero_counts(fns)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = hc.encode_long_video(frames, gids)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {name: f.launches for name, f in fns.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    hc.encode_long_video(frames, gids)
    torch.cuda.synchronize()
    again_ms = (time.perf_counter() - t0) * 1e3
    zero_counts(fns)
    n_global = cfg.projector.global_.num_queries
    with torch.inference_mode():
        f = hc._to_dev(frames, model.model.norm.weight.dtype)
        ge = model.encode_guide(hc._to_dev(gids, torch.int64))
        t0 = time.perf_counter()
        ref = model.encode_visual(f[None], ge)[0]
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3
        t_loc, grids = LONG_VIDEO_FRAMES // LONG_VIDEO_RANKS, []
        with ranks_in_turn() as turn:
            for start in range(0, LONG_VIDEO_FRAMES, t_loc):
                local_raw, _ = model.encode_visual_shard(f[None, start:start + t_loc], ge, "video", start,
                                                         LONG_VIDEO_FRAMES, SoloGroup())
                grids.append(local_raw[0])
            turn["all"] = True
            _, global_tokens = model.encode_visual_shard(f[None, :t_loc], ge, "video", 0, LONG_VIDEO_FRAMES,
                                                         SoloGroup())
        local = post_process_visual_feature(model.hicom_config, torch.cat(grids)[None], "video",
                                            model.model.image_newline, False)[0]
        shares = torch.cat([local, global_tokens[0]])
    one, four = agreement(got, ref), agreement(shares, ref)
    parts = (agreement(shares[:-n_global], ref[:-n_global])[1], agreement(shares[-n_global:], ref[-n_global:])[1])
    log(f"[long-video] {card} | {LONG_VIDEO_FRAMES} frames of {cfg.vision_config.image_size}x"
        f"{cfg.vision_config.image_size} -> {tuple(got.shape)} tokens: encode_long_video {ms:.1f} ms, again "
        f"{again_ms:.1f} ms (host clock, guide encoder included), encode_visual {single_ms:.1f} ms | worst err/tol "
        f"against encode_visual "
        f"{one[1]:.3f} | launches K1 {launches['fullblock_attention']}, K2 {launches['flash_forward']}, K4 "
        f"{launches['fused_tile_attention']}, merge {launches['merge_partials']} | peak {peak_gb:.2f} GB")
    log(f"[long-video] {LONG_VIDEO_RANKS} ranks' shares in turn ({len(turn['parts'])} ranks' fp32 partials of "
        f"{turn['parts'][0][0].shape[0]} chunks each, one merge): worst err/tol against encode_visual {four[1]:.3f}, "
        f"max abs err {four[0]:.3g} (the local tokens alone {parts[0]:.3f}, the global ones {parts[1]:.3f}, each "
        f"over its own rms)")
    if got.shape != ref.shape or shares.shape != ref.shape or not (one[1] <= 1 and four[1] <= 1):
        raise AssertionError(f"[long-video] the sequence-parallel tokens disagree: {one}, {four}")
    for name in ("fullblock_attention", "flash_forward", "fused_tile_attention", "merge_partials"):
        if launches[name] <= 0:
            raise AssertionError(f"[long-video] encode_long_video never launched {name}")
    return launches


def ring_prefill_phase(card: str, hc) -> dict:
    """[ring-prefill]: seeded (1, 16,384, 3,584) embeddings through
    ``ring_prefill`` over Qwen2.5-7B's 28 layers against the decoder's direct
    prefill (last hidden and cache k/v within the gate, length and validity
    exact); one layer's q/k/v at that length split as an 8-rank ring splits
    them (2,048-token chunks, 36 causal K2 blocks, one merge per rank) against
    one causal K2 over all of it; then ``HICom._generate_ring`` of a
    128-frame prompt against ``HICom.generate``, 16 greedy ids equal but at
    near-ties. Returns the launches of the three sequence-parallel runs (the
    comparisons not counted)."""
    import torch

    from hicom_tpu_torch.models.qwen2 import KVCache
    from hicom_tpu_torch.ops.flash_attention import flash_forward, merge_partials
    from hicom_tpu_torch.parallel.mesh import world_mesh
    from hicom_tpu_torch.parallel.ring import ring_block, ring_prefill

    cfg, model = hc.config, hc.model
    tc, S = cfg.text_config, RING_TOKENS
    fns = seq_counters()
    total = {name: 0 for name in fns}

    def count():
        for name, f in fns.items():
            total[name] += f.launches
        zero_counts(fns)

    gen = torch.Generator(DEVICE).manual_seed(51)
    emb = torch.randn(1, S, tc.hidden_size, generator=gen, device=DEVICE).to(model.model.norm.weight.dtype)
    pos = torch.arange(S, device=DEVICE)[None]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    t0 = time.perf_counter()
    last, cache = ring_prefill(model, emb, pos, world_mesh(), "dp", cache_len=S)
    torch.cuda.synchronize()
    ring_ms = (time.perf_counter() - t0) * 1e3
    count()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.inference_mode():
        ref_cache = KVCache.zeros(tc.num_hidden_layers, 1, tc.num_key_value_heads, S, tc.head_dim,
                                  model.model.norm.weight.dtype, DEVICE)
        t0 = time.perf_counter()
        hidden = model.model(emb, pos, ref_cache, prefill_from_empty=True)
        torch.cuda.synchronize()
        direct_ms = (time.perf_counter() - t0) * 1e3
        zero_counts(fns)
        worst = max((agreement(last[0], hidden[0, -1:]), agreement(cache.k, ref_cache.k),
                     agreement(cache.v, ref_cache.v)), key=lambda a: a[1])
        exact = cache.length == S and bool(cache.valid.all())
    del cache, ref_cache, hidden, emb
    log(f"[ring-prefill] {card} | {S} tokens x {tc.num_hidden_layers} layers: ring_prefill {ring_ms:.1f} ms, "
        f"direct prefill {direct_ms:.1f} ms (host clock) | last hidden and cache k/v worst err/tol {worst[1]:.3f} | "
        f"length and validity exact: {exact} | peak {peak_gb:.2f} GB")
    if not (worst[1] <= 1 and exact):
        raise AssertionError(f"[ring-prefill] ring_prefill disagrees with the direct prefill: {worst}, exact {exact}")

    H, KVH, d = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    q = torch.randn(1, H, S, d, generator=gen, device=DEVICE).to(model.model.norm.weight.dtype)
    k, v = (torch.randn(1, KVH, S, d, generator=gen, device=DEVICE).to(model.model.norm.weight.dtype) for _ in range(2))
    c, outs, blocks = S // RING_RANKS, [], 0
    chunk = lambda x, i: x[:, :, i * c:(i + 1) * c]  # noqa: E731
    t0 = time.perf_counter()
    with torch.inference_mode():
        for idx in range(RING_RANKS):
            parts = [p for p in (ring_block(chunk(q, idx), chunk(k, src), chunk(v, src), idx, src, scale=d**-0.5,
                                            is_causal=True) for src in range(RING_RANKS)) if p is not None]
            blocks += len(parts)
            outs.append(merge_partials(*(torch.cat(t) for t in zip(*parts)), q.dtype)[0])
        split = torch.cat(outs, dim=2)
        torch.cuda.synchronize()
        split_ms = (time.perf_counter() - t0) * 1e3
        count()
        whole = flash_forward(q, k, v, None, d**-0.5, 0.0, True)[0]
        zero_counts(fns)
    ratio = agreement(split, whole)[1]
    log(f"[ring-prefill] {RING_RANKS}-rank split of one layer ({H}/{KVH} heads, d {d}, {c}-token chunks): {blocks} K2 "
        f"blocks and {RING_RANKS} merges in {split_ms:.1f} ms (host clock) | worst err/tol against one causal K2 "
        f"over {S} tokens {ratio:.3f}")
    if blocks != RING_RANKS * (RING_RANKS + 1) // 2 or not ratio <= 1:
        raise AssertionError(f"[ring-prefill] the {RING_RANKS}-rank split: {blocks} blocks, worst err/tol {ratio}")
    del q, k, v, split, whole, outs

    frames, gids = long_video(cfg)
    rng = np.random.default_rng(52)
    ids = rng.integers(0, tc.vocab_size, (1, 64))
    ids[0, 5] = -201  # <video>
    V = model.visual_token_count(LONG_VIDEO_FRAMES, "video")
    cache_len = max(hc.cache_len_for(64, V, 16), 64 + V - 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = hc._generate_ring(ids, frames[None], gids, None, None, "video", 16, 0.0, 0.9, 0, (), cache_len)
    ring_s = time.perf_counter() - t0
    count()
    tops, logits = [], model.logits

    def recording(h):
        out = logits(h)
        tops.append(out[:, -1].float().topk(2, dim=-1).values[0])
        return out

    model.logits = recording
    try:
        t0 = time.perf_counter()
        ref = hc.generate(ids, frames=frames[None], guide_ids=gids, max_new_tokens=16)
        plain_s = time.perf_counter() - t0
    finally:
        del model.logits
    zero_counts(fns)
    div = first_divergence(got[0].tolist(), ref[0].tolist(), torch.stack(tops).cpu())
    log(f"[ring-prefill] _generate_ring of a {LONG_VIDEO_FRAMES}-frame prompt ({64 - 1 + V} spliced tokens, "
        f"{cache_len} slots): {ring_s:.3f} s against generate's {plain_s:.3f} s | ids {got[0].tolist()} | "
        f"{'equal' if div is None else f'part at {div[0]}, top-2 gap {div[1]:.3g} of the top logit'} | launches "
        f"in the phase {total}")
    if div is not None and div[1] > NEAR_TIE:
        raise AssertionError(f"[ring-prefill] _generate_ring parts from generate at {div[0]} (gap {div[1]:.3g})")
    for name in ("flash_forward", "merge_partials", "flash_decode"):
        if total[name] <= 0:
            raise AssertionError(f"[ring-prefill] the ring paths never launched {name}")
    return total


def pipeline_phase(card: str, hc) -> dict:
    """[pipeline]: ``pipeline_prefill`` at pp 1 (2 microbatches, b 2, 743
    tokens) over Qwen2.5-7B's 28 layers against the cache-less decoder
    forward, within the gate. Returns its launches."""
    import torch

    from hicom_tpu_torch.parallel import create_pp_mesh, pipeline_prefill

    model, tc = hc.model, hc.config.text_config
    gen = torch.Generator(DEVICE).manual_seed(53)
    b, L = 2, 743
    emb = torch.randn(b, L, tc.hidden_size, generator=gen, device=DEVICE).to(model.model.norm.weight.dtype)
    pos = torch.arange(L, device=DEVICE)[None].expand(b, L)
    mesh = create_pp_mesh(1)
    fns = seq_counters()
    with torch.inference_mode():
        zero_counts(fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pipeline_prefill(model, emb, pos, mesh, num_microbatches=2)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {name: f.launches for name, f in fns.items()}
        ref = model.model(emb, pos)
        zero_counts(fns)
    ratio = agreement(got, ref)[1]
    log(f"[pipeline] {card} | pipeline_prefill at pp 1, 2 microbatches, b {b} x {L} tokens, "
        f"{tc.num_hidden_layers} layers: {ms:.1f} ms (host clock) | worst err/tol against the decoder forward "
        f"{ratio:.3f} | K2 launches {launches['flash_forward']}")
    if not ratio <= 1 or launches["flash_forward"] != 2 * tc.num_hidden_layers:
        raise AssertionError(f"[pipeline] worst err/tol {ratio}, K2 launches {launches['flash_forward']}")
    return launches


# ---------------------------------------------------------------------------
# Tensor-parallel serving and data-parallel eval at HICom-7B: [mesh-serve], [eval-dp]
# ---------------------------------------------------------------------------


def tp_collectives() -> int:
    """The tp collectives issued so far (all-reduces and gathers, counted by their wrappers)."""
    from hicom_tpu_torch.parallel.sharding import all_gather_tp, all_reduce_tp

    return all_reduce_tp.launches + all_gather_tp.launches


def mesh_serve_phase(card: str, hc) -> dict:
    """[mesh-serve]: ``ServeEngine(mesh=world_mesh())`` at tp 1 on [slice]'s
    model over [serve-engine]'s 8 requests, graphed, in one pass (its first
    round of each kind is the eager warm-up, the second captured, with the
    tp collectives inside the graph). Gates: its streams equal
    [serve-engine]'s graphed streams bit for bit; every captured round holds
    collectives; K1-K4 launched (K3 counted per replay); afterwards an engine
    without a mesh on the caller's model gives the same streams. Prints the
    collectives a captured round holds, a graphed decode round with 4 slots
    resident beside [serve-engine]'s, aggregate tokens/s and the peak."""
    import torch

    from hicom_tpu_torch.api import serve_engine
    from hicom_tpu_torch.parallel.mesh import world_mesh
    from hicom_tpu_torch.serve import ServeEngine

    ref = ENGINE_REFERENCE
    t_phase = time.perf_counter()
    fns = counters()
    zero_counts(fns)
    cap0, rep0, issued = ServeEngine.k3_captured, ServeEngine.k3_replayed, tp_collectives()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = serve_engine(hc, ref["tok"], cuda_graphs=True, mesh=world_mesh(), **ENGINE)
    streams, res, wall, rounds = drive(eng, ref["reqs"])
    launches = {name: f.launches for name, f in fns.items()}
    captured, replayed = ServeEngine.k3_captured - cap0, ServeEngine.k3_replayed - rep0
    launches["flash_decode"] += replayed - captured
    tps = engine_line("tp 1, graphed", card, streams, res, wall, rounds, phase="mesh-serve")
    kv_heads, held = eng.cache.k.shape[2], dict(eng.graph_collectives)
    idle = round_idle(eng, ref["prof_reqs"])
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[mesh-serve] {card} | tp collectives captured a round {held} (K3 {eng.graph_launches}), "
        f"{tp_collectives() - issued} issued in all | replays {eng.replays} | cache kv heads {kv_heads} | "
        f"aggregate {tps:.1f} tokens/s in its one pass, captures included ([serve-engine]'s first graphed pass "
        f"{ref['first_pass_tokens_per_s']:.1f}) | peak memory {peak:.2f} GB (all of [serve-engine]: "
        f"{ref['peak_gb']:.2f})")
    if idle is not None:
        round_ms, wall_ms, busy, span = idle
        steps = ENGINE["sync_steps"]
        ref_ms = "not measured" if ref["round_ms"] is None else f"{ref['round_ms']:.1f} ms"
        log(f"[mesh-serve] graphed decode round, 4 slots resident: {round_ms:.1f} ms ({round_ms / steps:.2f} ms a "
            f"step) against [serve-engine]'s {ref_ms} | the next under torch.profiler: wall {wall_ms:.1f} ms, "
            f"device kernels {busy:.1f} ms, events {span:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    del eng
    again = serve_engine(hc, ref["tok"], cuda_graphs=True, **ENGINE)
    after = drive(again, ref["reqs"])[0]
    del again
    torch.cuda.empty_cache()
    log(f"[mesh-serve] launches: {launches} (K3: {replayed} by replays, {captured} capture calls taken out) | "
        f"streams == [serve-engine]'s graphed: {streams == ref['streams']} | the caller's model afterwards: "
        f"{after == ref['streams']} | phase {time.perf_counter() - t_phase:.1f} s")
    if streams != ref["streams"]:
        raise AssertionError(f"[mesh-serve] streams differ from [serve-engine]'s: {streams} vs {ref['streams']}")
    if after != ref["streams"]:
        raise AssertionError("[mesh-serve] the caller's model no longer gives [serve-engine]'s streams")
    if not held or min(held.values()) <= 0:
        raise AssertionError(f"[mesh-serve] a captured round holds no tp collective: {held}")
    if min(launches.values()) <= 0 or replayed <= 0:
        raise AssertionError(f"[mesh-serve] K1-K4 not all launched: {launches}, K3 by replays {replayed}")
    return launches


EVAL_DP_FRAMES = 8  # the short videos of [eval-dp]


def eval_dp_phase(card: str, hc) -> dict:
    """[eval-dp]: ``HICom.shard_for_eval()`` on [slice]'s model in the
    one-rank group, then ``mm_infer_batch`` over 4 seeded videos of 8
    frames, greedy, 16 new tokens: the batch divides the one data rank, so
    it runs as that rank's rows and the ids pass through the all-gather.
    Gate: the strings of the unsharded call before it. Returns the sharded
    call's launches by wrapper."""
    import torch

    from hicom_tpu_torch.api import mm_infer_batch

    cfg, tok = hc.config, ENGINE_REFERENCE["tok"]
    rng = np.random.default_rng(60)
    size, gcfg = cfg.vision_config.image_size, cfg.guide_text_config
    videos = list(rng.uniform(-1, 1, (4, EVAL_DP_FRAMES, 3, size, size)).astype(np.float32))
    instructs = [" ".join(f"q{int(w)}" for w in rng.integers(0, 10**6, 24)) for _ in videos]
    guide_ids = rng.integers(0, gcfg.vocab_size, (4, gcfg.max_position_embeddings))

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts = mm_infer_batch(videos, instructs, hc, tok, guide_ids=guide_ids, max_new_tokens=16)
        return texts, time.perf_counter() - t0

    want, t_plain = run()
    fns = counters()
    zero_counts(fns)
    mesh = hc.shard_for_eval()
    try:
        got, t_dp = run()
    finally:
        hc.eval_mesh = None
    launches = {name: f.launches for name, f in fns.items()}
    log(f"[eval-dp] {card} | shard_for_eval mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} | mm_infer_batch of 4 "
        f"videos of {EVAL_DP_FRAMES} frames, 16 new tokens: {t_dp:.3f} s sharded, {t_plain:.3f} s unsharded | "
        f"strings equal: {got == want} | launches {launches}")
    if got != want:
        raise AssertionError(f"[eval-dp] sharded strings differ from the unsharded call's: {got} vs {want}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"[eval-dp] K1-K4 not all launched: {launches}")
    return launches


SEQ_PHASES = ("long-video", "ring-prefill", "pipeline")
SLICE_C_PHASES = ("mesh-serve", "eval-dp")


def group_phases(card: str, hc, names=SEQ_PHASES + SLICE_C_PHASES) -> dict:
    """On [slice]'s HICom-7B (its decoder norms at 1, after [serve-engine]),
    in one one-rank NCCL group (torchrun's environment set in the process,
    ``init_distributed``): [seq-parallel]'s [long-video], [ring-prefill] and
    [pipeline], then [mesh-serve] and [eval-dp] (of ``names``). Returns each
    one's launches by wrapper."""
    import torch
    import torch.distributed as dist

    from hicom_tpu_torch.parallel.mesh import init_distributed

    phases = {"long-video": long_video_phase, "ring-prefill": ring_prefill_phase, "pipeline": pipeline_phase,
              "mesh-serve": mesh_serve_phase, "eval-dp": eval_dp_phase}
    out, seconds = {}, {}
    with mesh_env(free_port()):
        init_distributed(DEVICE, 1, 1, 1)
        try:
            for name in names:
                t0 = time.perf_counter()
                out[name] = phases[name](card, hc)
                seconds[name] = round(time.perf_counter() - t0, 1)
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"[one-rank group] seconds by phase {seconds}, {sum(seconds.values()):.1f} s in all")
    return out


def stage3_lora_phase(card: str):
    """Phase 5b: stage 3 through the JAX CLI's ``--lora-enable`` route (the
    one stage 3 that fits one card at 7B) at the full width and depth of
    HICom-7B: its defaults ``--lora-r 128 --lora-alpha 256`` on the decoder's
    seven linears, ``--remat`` on the tower and decoder, lr 1e-5, 3 steps on
    the stage-2 batch. The base stays bit-identical, every adapter's B moves,
    each step launches the flash backward once per decoder layer (the
    projector is frozen) and the flash forward twice per decoder layer (its
    recompute) plus once for the global compressor. Returns the kernels'
    launches over the 3 steps."""
    import dataclasses

    import torch

    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.train.lora import init_lora_params
    from hicom_tpu_torch.train.train_step import batch_to_device, create_lora_state, make_lora_train_step

    cfg = serving_config()  # with every decoder and tower layer checkpointed (the CLI's --remat)
    cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, remat=True),
                      vision_config=dataclasses.replace(cfg.vision_config, remat=True))
    model = build_model(cfg, device="cuda", seed=0)
    lora = init_lora_params(model, rank=128, generator=torch.Generator("cuda").manual_seed(0))
    state = create_lora_state(model, lora, alpha=256.0, rank=128, learning_rate=1e-5, total_steps=TRAIN_STEPS + 2)
    del lora
    n_adapter = sum(p.numel() for p in state.lora.parameters())
    log(f"[stage3-lora] HICom-7B, remat on: {len(state.lora.names)} adapted linears, {n_adapter / 1e6:.1f} M adapter "
        f"parameters (fp32), {sum(p.numel() for p in model.parameters()) / 1e9:.2f} B frozen (bf16)")
    base_before = bit_sums(model.named_parameters())
    b_before = {n: b.detach().clone() for n, b in state.lora.b.items()}
    batch = batch_to_device(make_train_batch(cfg), torch.device("cuda"), torch.bfloat16)
    step = make_lora_train_step()

    reset_counts()
    times, metrics, fwd, bwd = run_steps(state, step, batch)
    launches = log_steps("stage3-lora", card, f"HICom-7B stage 3 LoRA r 128 ({n_adapter / 1e6:.1f} M adapter "
                         "parameters), remat", model, cfg, batch, times, metrics, fwd, bwd)
    n_layers = cfg.text_config.num_hidden_layers
    if bwd != [n_layers] * TRAIN_STEPS:
        raise AssertionError(f"[stage3-lora] flash backward launched {bwd} times per step, not {n_layers}")
    if fwd != [2 * n_layers + 1] * TRAIN_STEPS:
        raise AssertionError(f"[stage3-lora] flash forward launched {fwd} times per step, not {2 * n_layers + 1} "
                             "(each decoder layer, its recompute, the global compressor)")
    if launches["fused_tile_attention"] or launches["flash_decode"]:
        raise AssertionError(f"[stage3-lora] a kernel without a backward ran in training: {launches}")
    after = bit_sums(model.named_parameters())
    changed = [n for n in base_before if not torch.equal(after[n], base_before[n])]
    still = [n for n, b in state.lora.b.items() if torch.equal(b.detach(), b_before[n])]
    if changed or still:
        raise AssertionError(f"[stage3-lora] {len(changed)} base tensors changed (e.g. {changed[:3]}), "
                             f"{len(still)} adapter B left unmoved (e.g. {still[:3]})")
    log(f"[stage3-lora] checks: {len(base_before)} base tensors kept their bits; all {len(b_before)} adapter B moved")
    train_profile("stage3-lora", state, step, batch, state.lora.parameters(), state.optimizer.step)
    state.lora.detach()
    del model, state, base_before, b_before, batch
    torch.cuda.empty_cache()
    return launches


STAGE3_PARTS = "mm_projector,language_model,vision_model_head,guide_encoder"


def config_1p5b():
    """The repo's other supported width: SigLIP-so400m + a Qwen2.5-1.5B decoder
    as ``bench.py:253-274`` shapes it (hidden 1536, 12/2 heads of 128,
    intermediate 8960, 28 layers), bf16. It keeps the config's default
    ``tie_word_embeddings=False``, so its 151,936-row embedding and head are
    two tensors: the repo's untied variant of the 1.5B shape. The published
    Qwen2.5-1.5B ties them, and has 233 M fewer parameters to train."""
    from hicom_tpu_torch.config import Qwen2Config

    return serving_config().replace(text_config=Qwen2Config(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960, num_hidden_layers=28, num_attention_heads=12,
        num_key_value_heads=2, head_dim=128, rope_theta=1000000.0))


def stage3_sft_phase(card: str, resident=None):
    """Phase 5c: full stage-3 SFT of the recipe (``--mm-tunable-parts
    mm_projector,language_model,vision_model_head,guide_encoder``, lr 1e-5,
    vision-tower lr 2e-6, guide-injector lr 1e-3) at the full width and depth
    of the 1.5B configuration: 3 steps on a seeded batch of 2. The tower trunk
    stays bit-identical; every trained tensor whose last gradient reaches
    AdamW's eps in magnitude has a moved fp32 master (below eps a step is lr
    |g| / eps, which may round away), and the tower head, guide encoder,
    projector and decoder each have moved tensors; each step launches the
    flash forward and backward once per decoder layer and once for the global
    compressor. Returns the kernels' launches over the 3 steps and the run's
    reference: its flat fp32 masters and losses after the 3 steps.

    With ``resident`` (that reference) it is ``[stage3-sft-offload]``: the
    same steps from the same seed with the AdamW moments in pinned host
    memory (``--offload-optimizer``). Every master must equal the resident
    run's (an element that differs may do so by one fp32 ulp, printed), the
    losses agree, and the pinned bytes stay within 10% of the moments'."""
    import torch

    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.parallel.sharding import pinned_bytes
    from hicom_tpu_torch.train.optimizer import build_optimizer, trainable_param_count
    from hicom_tpu_torch.train.train_step import batch_to_device, create_train_state, make_train_step

    offload = resident is not None
    label = "stage3-sft-offload" if offload else "stage3-sft"
    cfg = config_1p5b()
    model = build_model(cfg, device="cuda", seed=0)
    opt = build_optimizer(model, learning_rate=1e-5, vision_tower_lr=2e-6, guide_injector_lr=1e-3,
                          total_steps=TRAIN_STEPS + 2, tunable_parts=STAGE3_PARTS, use_guide="direct")
    pinned0 = pinned_bytes()
    t0 = time.perf_counter()
    state = create_train_state(model, opt, offload_optimizer=offload)
    torch.cuda.synchronize()
    init_s, pinned = time.perf_counter() - t0, pinned_bytes() - pinned0
    params = dict(model.named_parameters())
    trained = {n for n, p in params.items() if p.requires_grad}
    moment_bytes = 8 * opt.flat.numel()
    log(f"[{label}] 1.5B: {trainable_param_count(model, STAGE3_PARTS, 'direct') / 1e9:.3f} B trained parameters "
        f"(fp32 masters + AdamW moments), {sum(p.numel() for n, p in params.items() if n not in trained) / 1e9:.3f} B "
        f"frozen (bf16); moments {moment_bytes / 1e9:.3f} GB {'in pinned host memory' if offload else 'on the card'}, "
        f"pinned {pinned / 1e9:.3f} GB, state made in {init_s:.1f} s")
    before = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}  # host copies
    batch = batch_to_device(make_train_batch(cfg), torch.device("cuda"), torch.bfloat16)
    step = make_train_step()

    reset_counts()
    times, metrics, fwd, bwd = run_steps(state, step, batch)
    launches = log_steps(label, card, "1.5B stage 3 full SFT" + (", AdamW moments offloaded" if offload else ""),
                         model, cfg, batch, times, metrics, fwd, bwd)
    n_layers = cfg.text_config.num_hidden_layers
    if bwd != [n_layers + 1] * TRAIN_STEPS or fwd != [n_layers + 1] * TRAIN_STEPS:
        raise AssertionError(f"[{label}] flash forward / backward launched {fwd} / {bwd} times per step, not "
                             f"{n_layers + 1} (each decoder layer, the global compressor)")
    if launches["fused_tile_attention"] or launches["flash_decode"]:
        raise AssertionError(f"[{label}] a kernel without a backward ran in training: {launches}")
    changed = [n for n, p in params.items() if n not in trained and not torch.equal(p.detach(), before[n].to(p.device))]
    if changed:
        raise AssertionError(f"[{label}] {len(changed)} frozen tensors changed, e.g. {changed[:3]}")
    masters, eps = state.optimizer.masters, state.optimizer.eps
    moved = {n for n in trained if not torch.equal(masters[n], before[n].to(masters[n].device).float())}
    top = {n: float(params[n].grad.abs().max()) if params[n].grad is not None else 0.0 for n in trained}
    parts = {"tower head": "vision_tower.vision_tower.", "guide encoder": "guide_encoder.",
             "projector": "mm_projector.", "decoder": None}
    summary, idle = [], []
    for part, key in parts.items():
        names = [n for n in trained if (key in n if key else not any(k and k in n for k in parts.values()))]
        n_moved = sum(n in moved for n in names)
        summary.append(f"{part} {n_moved}/{len(names)} moved, {sum(top[n] >= eps for n in names)} with max |grad| "
                       f">= eps, max |grad| {max(top[n] for n in names):.3g}")
        if not n_moved:
            idle.append(part)
    unmoved = sorted(n for n in trained if n not in moved)
    trunk = [n for n in params if "vision_tower.vision_tower." in n and n not in trained]
    log(f"[{label}] checks: {len(trunk)} tower trunk tensors (of {len(params) - len(trained)} frozen) "
        f"bit-identical; trained tensors (fp32 masters, last step's gradients, eps {eps:g}): " + "; ".join(summary))
    log(f"[{label}] {len(unmoved)} trained tensors unmoved, with their last max |grad|: "
        + ", ".join(f"{n} {top[n]:.3g}" for n in unmoved))
    stuck = [n for n in unmoved if top[n] >= eps]
    if stuck or idle:
        raise AssertionError(f"[{label}] {len(stuck)} tensors with max |grad| >= eps did not move (e.g. "
                             f"{stuck[:3]}); parts that did not move: {idle}")
    losses = [m["loss"] for m in metrics]
    if offload:
        same_masters(label, opt.flat, resident[0])
        if max(abs(a - b) / abs(b) for a, b in zip(losses, resident[1])) > 1e-5:
            raise AssertionError(f"[{label}] losses {losses} against the resident run's {resident[1]}")
        if abs(pinned - moment_bytes) > 0.1 * moment_bytes:
            raise AssertionError(f"[{label}] pinned {pinned} bytes for {moment_bytes} bytes of moments")
        log(f"[{label}] losses {losses} equal the resident run's {resident[1]}; link per step {moment_bytes / 1e9:.3f} "
            f"GB host -> device and {moment_bytes / 1e9:.3f} GB device -> host")
    reference = None if offload else (opt.flat.clone(), losses)
    train_profile(label, state, step, batch, model.parameters(), lambda: state.optimizer.update(model))
    del model, state, opt, params, before, batch
    torch.cuda.empty_cache()
    return launches, reference


def same_masters(label: str, got, want, chunk: int = 1 << 26):
    """Fails unless the flat fp32 masters ``got`` equal ``want``, an element
    allowed to differ by one fp32 ulp of ``want``'s value (the largest
    difference in ulps and the count of differing elements are printed)."""
    differ, worst = 0, 0.0
    for a in range(0, want.numel(), chunk):
        n, most = ulp_distance(got[a:a + chunk], want[a:a + chunk])
        differ, worst = differ + n, max(worst, most)
    log(f"[{label}] masters against the resident run's: {differ} of {want.numel()} elements differ, the largest by "
        f"{worst:g} fp32 ulp")
    if worst > 1:
        raise AssertionError(f"[{label}] masters differ from the resident run's by up to {worst:g} ulp")


def ulp_distance(got, want):
    """(elements of ``got`` that differ from ``want``, the largest difference
    in fp32 ulp of ``want``'s value)."""
    import torch

    ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs()
    return int((got != want).sum()), float(((got - want).abs() / ulp).max())


def link_rates(pieces: int = 4, piece: int = 1 << 26, reps: int = 5) -> dict:
    """The host link's own rate in GB/s: 1 GB of pinned fp32 (4 pieces of 256
    MB, as the update walk streams them) host -> device, device -> host, and
    both at once on two streams (their sum); the median of ``reps`` timed
    rounds on the host clock around synchronised copies, after one warm-up."""
    import torch

    from hicom_tpu_torch.parallel.sharding import host_pieces

    host = [host_pieces(pieces * piece, piece, "cuda") for _ in range(2)]
    dev = [torch.empty(pieces * piece, device="cuda") for _ in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]

    def h2d():
        with torch.cuda.stream(streams[0]):
            for i, p in enumerate(host[0]):
                dev[0][i * piece:(i + 1) * piece].copy_(p, non_blocking=True)

    def d2h():
        with torch.cuda.stream(streams[1]):
            for i, p in enumerate(host[1]):
                p.copy_(dev[1][i * piece:(i + 1) * piece], non_blocking=True)

    rates = {}
    for name, fns in (("h2d", (h2d,)), ("d2h", (d2h,)), ("both", (h2d, d2h))):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in fns:
                f()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rates[name] = len(fns) * 4 * pieces * piece / float(np.median(times[1:])) / 1e9
    del host, dev
    return rates


def stage3_sft_7b_offload_phase(card: str):
    """Phase 9, ``[stage3-sft-7b-offload]``: full stage-3 SFT of HICom-7B at
    full width and depth on one card with the AdamW moments in pinned host
    memory (``--offload-optimizer``): ``[stage3-sft]``'s parts and learning
    rates, ``--remat`` on the tower and decoder as ``[stage3-lora]`` sets it,
    batch 1 (the first row of the stage-2 batch, 32 frames), 3 steps, the
    third split into forward + loss, backward and update on the host clock.
    It prints the trained and frozen counts, the pinned bytes against the
    moments', the peak against the card's memory, the link's bytes a step and
    the rate reached beside the link's own rate (``link_rates``), and the
    update's bound (the moments' bytes both ways over the both-at-once rate).
    It checks: finite losses; the frozen tensors' bits; moved masters
    in each part; for a sample (decoder layer 0's seven linears, the
    embedding's first 64 rows, the tower head), the third step's masters and
    moments against ``torch.optim.AdamW``'s single-tensor step on the card
    from a snapshot taken before that update (masters, moments read back
    from pinned memory, the gradients), each element within one fp32 ulp; 57
    flash forward (each decoder layer, its recompute, the global compressor)
    and 29 flash backward launches a step. Out of memory, it prints the peak
    and the allocator's summary and fails. Saves no checkpoint (masters and
    moments are 97 GB). Returns the kernels' launches over the 3 steps."""
    import dataclasses

    import torch

    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.parallel.sharding import pinned_bytes
    from hicom_tpu_torch.train.optimizer import build_optimizer
    from hicom_tpu_torch.train.train_step import batch_to_device, create_train_state, make_loss_fn, make_train_step

    label = "stage3-sft-7b-offload"
    rates = link_rates()
    log(f"[{label}] {card} | link, 1 GB of pinned fp32 in 256 MB pieces: host -> device {rates['h2d']:.2f} GB/s, "
        f"device -> host {rates['d2h']:.2f} GB/s, both at once {rates['both']:.2f} GB/s in sum")
    cfg = serving_config()
    cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, remat=True),
                      vision_config=dataclasses.replace(cfg.vision_config, remat=True))
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    opt = build_optimizer(model, learning_rate=1e-5, vision_tower_lr=2e-6, guide_injector_lr=1e-3,
                          total_steps=TRAIN_STEPS + 2, tunable_parts=STAGE3_PARTS, use_guide="direct")
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    pinned0 = pinned_bytes()
    t0 = time.perf_counter()
    state = create_train_state(model, opt, offload_optimizer=True)
    torch.cuda.synchronize()
    init_s, pinned = time.perf_counter() - t0, pinned_bytes() - pinned0
    params = dict(model.named_parameters())
    trained = {n for n, p in params.items() if p.requires_grad}
    n_trained = opt.flat.numel()
    moment_bytes = 8 * n_trained
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    log(f"[{label}] HICom-7B, remat on: {n_trained / 1e9:.3f} B trained parameters, "
        f"{sum(p.numel() for n, p in params.items() if n not in trained) / 1e9:.3f} B frozen; model built in "
        f"{built_s:.1f} s, state in {init_s:.1f} s; moments {moment_bytes / 1e9:.3f} GB in pinned host memory, "
        f"pinned {pinned / 1e9:.3f} GB ({pinned / moment_bytes:.4f} of the moments); on the card "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of {total_gb:.2f} GB before the first step")
    if abs(pinned - moment_bytes) > 0.1 * moment_bytes:
        raise AssertionError(f"[{label}] pinned {pinned} bytes for {moment_bytes} bytes of moments")
    frozen_before = bit_sums((n, p) for n, p in params.items() if n not in trained)
    heads = [n for n in trained if n.startswith("model.vision_tower.vision_tower.")]
    layer0 = [n for n in trained if n.startswith("model.layers.0.") and n.endswith("_proj.weight")]
    rows = 64
    sample = {n: None for n in layer0 + heads}
    sample["model.embed_tokens.weight"] = rows
    if len(layer0) != 7 or not heads:
        raise AssertionError(f"[{label}] sample: decoder layer 0's linears {layer0}, tower head {heads}")
    prefix = {n: opt.masters[n].reshape(-1)[:4096].clone() for n in trained}
    batch = batch_to_device({k: v[:1] for k, v in make_train_batch(cfg).items()}, torch.device("cuda"),
                            torch.bfloat16)
    step = make_train_step()
    fns = counters(train=True)

    reset_counts()
    try:
        times, metrics, fwd, bwd = run_steps(state, step, batch, n=TRAIN_STEPS - 1)
        peak_steps = torch.cuda.max_memory_allocated() / 1e9
        # the third step by hand, split into stages, with the snapshot of the sample before its update
        f0, b0 = fns["flash_forward"].launches, fns["flash_backward"].launches
        stamps = [time.perf_counter()]
        for p in model.parameters():
            p.grad = None
        loss, m = make_loss_fn(model)(batch)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        snap = adam_snapshot(opt, params, sample)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        m["grad_norm"] = opt.update(model)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    except torch.cuda.OutOfMemoryError:
        log(f"[{label}] out of memory: peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB of {total_gb:.2f} GB")
        log(torch.cuda.memory_summary(abbreviated=True))
        raise
    state.step += 1
    times.append(stamps[2] - stamps[0] + stamps[4] - stamps[3])
    fwd.append(fns["flash_forward"].launches - f0)
    bwd.append(fns["flash_backward"].launches - b0)
    metrics.append({k: float(v) for k, v in m.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: f.launches for name, f in fns.items()}
    for i, mt in enumerate(metrics):
        log(f"[{label}] step {i + 1}: " + ", ".join(f"{k} {v:.6g}" for k, v in mt.items()) + f", {times[i] * 1e3:.1f} ms")
    fwd_s, bwd_s, upd_s = stamps[1] - stamps[0], stamps[2] - stamps[1], stamps[4] - stamps[3]
    link = 2 * moment_bytes  # the moments in and out each step
    bound_s = link / (rates["both"] * 1e9)
    spliced = model.visual_token_count(cfg.num_frames, "video") + batch["input_ids"].shape[1] - 1
    log(f"[{label}] {card} | HICom-7B stage 3 full SFT, moments offloaded, remat, batch 1 x {cfg.num_frames} frames, "
        f"{spliced} spliced tokens | step {times[1] * 1e3:.1f} ms (step 2; step 1 {times[0] * 1e3:.1f} ms), step 3 "
        f"forward + loss {fwd_s * 1e3:.1f} ms, backward {bwd_s * 1e3:.1f} ms, update {upd_s * 1e3:.1f} ms | peak "
        f"memory {peak_steps:.2f} GB of {total_gb:.2f} GB over steps 1-2 ({peak_gb:.2f} GB with step 3's sample "
        f"snapshot) | link per step {moment_bytes / 1e9:.3f} GB host -> device "
        f"and {moment_bytes / 1e9:.3f} GB device -> host, {link / upd_s / 1e9:.2f} GB/s reached in the update "
        f"(both directions in sum) | update bound {bound_s * 1e3:.1f} ms (moments both ways at "
        f"{rates['both']:.2f} GB/s), measured {upd_s / bound_s:.2f}x it")
    log(f"[{label}] launches over {TRAIN_STEPS} steps: {launches}; flash_forward per step {fwd}, flash_backward per "
        f"step {bwd}")
    if not all(np.isfinite(v) for mt in metrics for v in mt.values()):
        raise AssertionError(f"[{label}] non-finite metrics: {metrics}")
    n_layers = cfg.text_config.num_hidden_layers
    if fwd != [2 * n_layers + 1] * TRAIN_STEPS or bwd != [n_layers + 1] * TRAIN_STEPS:
        raise AssertionError(f"[{label}] flash forward / backward launched {fwd} / {bwd} times per step, not "
                             f"{2 * n_layers + 1} / {n_layers + 1}")
    if launches["fused_tile_attention"] or launches["flash_decode"]:
        raise AssertionError(f"[{label}] a kernel without a backward ran in training: {launches}")
    after = bit_sums((n, params[n]) for n in frozen_before)
    changed = [n for n in frozen_before if not torch.equal(after[n], frozen_before[n])]
    parts = {"tower head": "vision_tower.vision_tower.", "guide encoder": "guide_encoder.",
             "projector": "mm_projector.", "decoder": None}
    summary, idle = [], []
    for part, key in parts.items():
        names = [n for n in trained if (key in n if key else not any(k and k in n for k in parts.values()))]
        n_moved = sum(not torch.equal(opt.masters[n].reshape(-1)[:4096], prefix[n]) for n in names)
        summary.append(f"{part} {n_moved}/{len(names)}")
        if not n_moved:
            idle.append(part)
    worst = adam_check(opt, params, sample, snap, float(m["grad_norm"]), count=TRAIN_STEPS - 1)
    log(f"[{label}] checks: {len(frozen_before)} frozen tensors kept their bits ({len(changed)} changed); "
        f"trained tensors whose first 4,096 master elements moved: {', '.join(summary)}; the sample's masters and "
        f"moments against torch.optim.AdamW's step: " + ", ".join(f"{k} {v[0]} elements differ, the largest by "
                                                                  f"{v[1]:g} ulp" for k, v in worst.items()))
    if changed or idle or any(v[1] > 1 for v in worst.values()):
        raise AssertionError(f"[{label}] frozen tensors changed {changed[:3]}, parts that did not move {idle}, "
                             f"the sample against AdamW {worst}")
    del model, state, opt, params, batch, snap, prefix
    torch.cuda.empty_cache()
    return launches


def adam_snapshot(opt, params, sample: dict) -> dict:
    """{name: (master, exp_avg, exp_avg_sq, gradient)} of the sample on the
    card before an update, the moments read back from their home (``sample``
    maps a name to None for the whole tensor, or to its first rows)."""
    snap = {}
    for n, rows in sample.items():
        o = opt.layout[n][0]
        master = opt.masters[n] if rows is None else opt.masters[n][:rows]
        size = master.numel()
        moments = [opt.home.read(kind, o, o + size).view(master.shape).to(master.device) for kind in
                   ("exp_avg", "exp_avg_sq")]
        grad = params[n].grad if rows is None else params[n].grad[:rows]
        snap[n] = (master.clone(), *moments, grad.clone())
    return snap


def adam_check(opt, params, sample: dict, snap: dict, grad_norm: float, count: int) -> dict:
    """The update from ``snap`` recomputed by ``torch.optim.AdamW`` (single
    tensor, decoupled decay) on the card: the gradient clipped by
    ``grad_norm`` as the optimizer clips, the group's rate at ``count``.
    Returns {"masters" / "exp_avg" / "exp_avg_sq": (elements that differ,
    the largest difference in fp32 ulp)} over the sample."""
    import torch

    out = {k: [0, 0.0] for k in ("masters", "exp_avg", "exp_avg_sq")}
    norm = torch.tensor(grad_norm, device=opt.flat.device)
    for n, rows in sample.items():
        master0, m0, v0, grad = snap[n]
        p = master0.clone()
        g = grad.float()
        g = torch.where(norm < opt.max_grad_norm, g, g / norm * opt.max_grad_norm)
        p.grad = g
        ref = torch.optim.AdamW([p], lr=opt.schedules[opt.labels[n]](count), betas=opt.betas, eps=opt.eps,
                                weight_decay=opt.weight_decay if opt.decay[n] else 0.0, foreach=False)
        ref.state[p] = {"step": torch.tensor(float(count)), "exp_avg": m0.clone(), "exp_avg_sq": v0.clone()}
        ref.step()
        o = opt.layout[n][0]
        got = {"masters": opt.masters[n] if rows is None else opt.masters[n][:rows]}
        for kind in ("exp_avg", "exp_avg_sq"):
            got[kind] = opt.home.read(kind, o, o + p.numel()).view(p.shape).to(p.device)
        want = {"masters": p.detach(), "exp_avg": ref.state[p]["exp_avg"], "exp_avg_sq": ref.state[p]["exp_avg_sq"]}
        for kind, w in want.items():
            n, most = ulp_distance(got[kind], w)
            out[kind] = [out[kind][0] + n, max(out[kind][1], most)]
    return {k: tuple(v) for k, v in out.items()}


def train_profile(label: str, state, step, batch, trainable, update, top: int = 12, loss_fn=None,
                  stages: bool = True):
    """One more step split into stages (host clock around synchronised
    stages: the frozen tower's forward alone, then the step's forward,
    backward and update; without ``stages`` none), then one under
    torch.profiler: device kernel time by kernel, by the aten op that
    launched it, and the device's idle share of the step's wall time.
    ``trainable`` are the parameters whose gradients a step starts from
    zero, ``update`` the optimizer's step, ``loss_fn`` the step's loss
    (default: a video batch's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hicom_tpu_torch.train.train_step import make_loss_fn

    model = state.model
    stamps = []

    def mark(name):
        torch.cuda.synchronize()
        stamps.append((name, time.perf_counter()))

    if stages:
        mark("start")
        with torch.no_grad():
            frames = batch["frames"]
            model.model.vision_tower.vision_tower(frames.reshape((-1,) + frames.shape[2:]))
        mark("vision tower forward (alone)")
        for p in trainable:
            p.grad = None
        loss, _ = (loss_fn or make_loss_fn(model))(batch)
        mark("forward + loss (tower included)")
        loss.backward()
        mark("backward")
        update()
        mark("optimizer update")
        log(f"[{label}-stages] " + " | ".join(f"{n} {1e3 * (t - stamps[i][1]):.1f} ms"
                                             for i, (n, t) in enumerate(stamps[1:])))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_time(e) for e in kernels)
    if busy_us <= 0:
        log(f"[{label}-profile] the profiler saw no device time")
        return
    log(f"[{label}-profile] step wall {wall_us / 1e3:.1f} ms, device kernels {busy_us / 1e3:.1f} ms, "
        f"idle share {1 - busy_us / wall_us:.3f}")
    for e in sorted(kernels, key=dev_time, reverse=True)[:top]:
        log(f"[{label}-profile]   {dev_time(e) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    # the same device time by the aten op that launched each kernel (its self
    # device time: kernels launched directly by the op, not by ops it calls)
    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::")
           and dev_time(e) > 0]
    log(f"[{label}-profile] by aten op: " + " | ".join(
        f"{e.key} {dev_time(e) / 1e3:.2f} ms x{e.count}" for e in sorted(ops, key=dev_time, reverse=True)[:top]))


def plain_vs_kernel_grads():
    """Phase 6b: at 2 decoder and 2 tower layers, the trained parameters'
    gradients of one stage-2 loss on the kernel path against the plain path's."""
    import torch

    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.ops.flash_attention import flash_backward
    from hicom_tpu_torch.train.optimizer import build_optimizer
    from hicom_tpu_torch.train.train_step import batch_to_device, make_loss_fn

    cfg = serving_config(layers=2)
    model = build_model(cfg, device="cuda", seed=4)
    build_optimizer(model, learning_rate=1e-3, tunable_parts="mm_projector", use_guide="direct").init(model)
    batch = batch_to_device(make_train_batch(cfg, seed=5), torch.device("cuda"), torch.bfloat16)
    loss_fn = make_loss_fn(model)

    def grads():
        for p in model.parameters():
            p.grad = None
        loss, _ = loss_fn(batch)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}

    before = flash_backward.launches
    loss_k, got = grads()
    launched = flash_backward.launches - before
    with plain_path():
        loss_p, ref = grads()
    if launched != 3 or flash_backward.launches - before != 3:
        raise AssertionError(f"the kernel path launched the flash backward {launched} times (2 layers + global: 3),"
                             " or the plain path launched it")
    if set(got) != set(ref):
        raise AssertionError("the two paths gave gradients to different parameters")
    diff = sum((got[n] - ref[n]).square().sum() for n in ref).sqrt().item()
    norm = sum(ref[n].square().sum() for n in ref).sqrt().item()
    # bf16 activations and gradients round at other points on the two paths
    # (flash tiles with P and dS rounded to bf16, against a whole-row fp32
    # softmax and its fp32 autograd) through 2 tower, 2 guide and 2 decoder
    # layers: hold the global relative difference of the gradients to 5%
    tol = 0.05
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    log(f"[train] 2-layer stage-2 gradients, kernel vs plain path: loss {loss_k:.6f} vs {loss_p:.6f}, "
        f"{len(got)} tensors, global |diff| / |plain| {diff / norm:.4g} (tol {tol}), |plain| {norm:.4g}, "
        f"finite {finite}")
    if not (finite and norm > 0 and diff <= tol * norm):
        raise AssertionError("kernel-path gradients disagree with the plain path")
    del model, got, ref, batch
    torch.cuda.empty_cache()


def last_logits(model, batch):
    """The last prompt token's logits (fp32) of each row of a request batch:
    the guide encoder, the tower and projector, the splice and the decoder
    prefill, as ``generate`` runs them before its first token."""
    import torch

    dev, dt = model.model.norm.weight.device, model.model.norm.weight.dtype
    with torch.inference_mode():
        ids = torch.as_tensor(batch["input_ids"], device=dev)
        mask = torch.as_tensor(batch["attention_mask"], device=dev)
        ge = model.encode_guide(torch.as_tensor(batch["guide_ids"], device=dev))
        vis = model.encode_visual(torch.as_tensor(batch["frames"], device=dev, dtype=dt), ge, "video")
        sp = model.embed_and_splice(ids, vis, mask)
        hidden = model.model(sp.embeds, sp.positions, padding_mask=sp.attention_mask)
        last = sp.attention_mask.sum(dim=1) - 1
        return model.logits(hidden[torch.arange(ids.shape[0], device=dev), last]).float()


def plain_vs_kernel_logits():
    """Phase 6a: at 2 decoder and 2 tower layers, the kernel path's last-token
    prefill logits against the plain path's, on the batch-of-2 request."""
    import torch

    from hicom_tpu_torch.api import build_model

    cfg = serving_config(layers=2)
    model = build_model(cfg, device="cuda", seed=2)
    batch, _ = make_requests(cfg, seed=3)
    got = last_logits(model, batch)
    with plain_path():
        ref = last_logits(model, batch)
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


class WordTokenizer:
    """A word-level stand-in for the Qwen2 and SigLIP tokenizers (the card has
    no ``transformers``): a word's id is a hash of its letters below
    ``vocab``, the chat template is plain text, and a list of texts (the guide
    encoder's call, padded to ``max_length``) gives ``input_ids`` alone, as
    SigLIP's tokenizer does."""

    pad_token_id = 0
    bos_token_id = None

    def __init__(self, vocab: int, max_length: int = 64):
        self.vocab, self.max_length = vocab, max_length

    def ids(self, text: str):
        return [sum(map(ord, w)) % (self.vocab - 3) + 3 for w in text.split()]

    def __call__(self, text, add_special_tokens=False, padding=None, truncation=None, return_tensors=None):
        if isinstance(text, str):
            return type("Encoding", (), {"input_ids": self.ids(text)})()
        out = np.full((len(text), self.max_length), self.pad_token_id, np.int64)
        for i, t in enumerate(text):
            row = self.ids(t)[: self.max_length]
            out[i, : len(row)] = row
        return {"input_ids": out}

    def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=False):
        text = "".join(f"<|{m['role']}|> {m['content']} <|end|> " for m in messages)
        return text + "<|assistant|> " if add_generation_prompt else text

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(f"w{int(i)}" for i in ids)

    def batch_decode(self, rows, skip_special_tokens=False):
        return [self.decode(r) for r in rows]


def write_base_dirs(llm: str, tower: str, cfg, seed: int, norms_at_one: bool = False) -> dict:
    """The base LLM directory ``llm`` (``config.json`` of a Qwen2 model and
    ``model.safetensors`` of its decoder) and the SigLIP tower directory
    ``tower`` (both towers, HF ``SiglipModel`` names), at ``cfg``'s widths
    with weights drawn on the card from ``seed`` (with ``norms_at_one``, the
    norms' weights 1 and biases 0, as ``transformers`` initialises them),
    written by the port itself (its own safetensors writer). Returns the
    model's state dict."""
    import dataclasses
    import os

    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.weights import save_safetensors

    sd = build_model(cfg, device=DEVICE, seed=seed).state_dict()
    for k, v in sd.items():
        if norms_at_one and "norm" in k.split(".")[-2]:
            v.fill_(1.0 if k.endswith(".weight") else 0.0)
    os.makedirs(llm)
    save_safetensors({k: v for k, v in sd.items() if not k.startswith(("model.mm_projector", "model.vision_tower"))},
                     os.path.join(llm, "model.safetensors"))
    with open(os.path.join(llm, "config.json"), "w") as f:
        json.dump({"model_type": "qwen2", **dataclasses.asdict(cfg.text_config)}, f)
    os.makedirs(tower)
    hosts = ("model.vision_tower.vision_tower.", "model.vision_tower.guide_encoder.")
    save_safetensors({k[len(h):]: v for k, v in sd.items() for h in hosts if k.startswith(h)},
                     os.path.join(tower, "model.safetensors"))
    with open(os.path.join(tower, "config.json"), "w") as f:
        json.dump({"model_type": "siglip", "vision_config": dataclasses.asdict(cfg.vision_config),
                   "text_config": dataclasses.asdict(cfg.guide_text_config)}, f)
    return sd


def write_cli_inputs(root: str, cfg, frames: int = 32, rows: int = 4) -> dict:
    """The trainer's input files under ``root``, at ``cfg``'s widths with
    seeded weights: the base LLM and tower directories (``write_base_dirs``),
    a stage-1 ``mm_projector.bin``, and ``data.json``: ``rows`` video rows,
    each a directory of ``frames`` PNG frames, with a question (the guide
    prompt) and an answer. Every file is written by the port itself."""
    import os

    import torch
    from PIL import Image

    from hicom_tpu_torch.train.checkpoints import export_mm_projector_bin

    paths = {k: os.path.join(root, v) for k, v in (("llm", "qwen2.5-7b-width"), ("tower", "siglip-so400m-width"),
                                                   ("bin", "stage1/mm_projector.bin"), ("data", "data.json"))}
    sd = write_base_dirs(paths["llm"], paths["tower"], cfg, seed=7)
    export_mm_projector_bin(sd, paths["bin"])
    del sd
    torch.cuda.empty_cache()

    rng = np.random.default_rng(8)
    data = []
    for r in range(rows):
        folder = f"video{r}"
        os.makedirs(os.path.join(root, folder))
        for i in range(frames):
            Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
                os.path.join(root, folder, f"{i:03d}.png"))
        data.append({"video": folder, "conversations": [
            {"from": "human", "value": f"<video>\nWhat does the cat do in clip {r}?"},
            {"from": "gpt", "value": f"The cat sits on the red mat and looks at the door {r} times."}]})
    with open(paths["data"], "w") as f:
        json.dump(data, f)
    return paths


def exported_weights(name: str, state, args) -> dict:
    """The weights ``load_model`` must read back from a ``[cli]`` stage's
    artifact, from the state ``cli.run`` returned: the model's own, with what
    the export writes in fp16 rounded through fp16 (the projector's fp32
    masters for ``mm_projector.bin``; every parameter, the masters of the
    trained ones, for ``hf_export``), or, for LoRA, with the adapters merged
    into the decoder's bf16 weights."""
    from hicom_tpu_torch.train.lora import apply_lora

    sd = state.model.state_dict()
    if name == "lora":
        return apply_lora(sd, state.lora.adapters(), alpha=args.lora_alpha, rank=args.lora_r)
    params = state.params()
    rounded = [n for n in sd if n.startswith("model.mm_projector.")] if name == "stage2" else list(sd)
    return {**sd, **{n: params[n].half().to(sd[n].dtype) for n in rounded}}


@contextmanager
def skipped_checkpoint(skip: bool):
    """While inside, with ``skip``, the trainer's ``save_checkpoint`` writes
    nothing: ``[cli]``'s resident full-SFT stage would write 19 GB of masters
    and moments that the phase deletes unread (about 15 s of the smoke's
    limit). ``sft-offload`` still writes its checkpoint, whose moments come
    from pinned host memory through the copy streams; a checkpoint's round
    trip is ``tests/test_torch_cli_port.py``'s and ``test_torch_offload.py``'s."""
    from hicom_tpu_torch.train import checkpoints

    saved = checkpoints.save_checkpoint
    if skip:
        checkpoints.save_checkpoint = lambda output_dir, state, step=None, max_to_keep=3: None
    try:
        yield
    finally:
        checkpoints.save_checkpoint = saved


def cli_phase(card: str):
    """Phase 7: the trainer's CLI from files at the width of HICom-7B with 2
    tower and 2 decoder layers: stage 2 (``--pretrain-weights``, 2 steps ->
    ``mm_projector.bin``), stage 3 through LoRA (2 steps -> a peft adapter),
    stage 3 QLoRA over an int8 base (``--bits 8``, 2 steps -> a peft adapter)
    and stage 3 full SFT (2 steps -> ``hf_export/``), each by
    ``hicom_tpu_torch.train.cli.run`` on the files ``write_cli_inputs``
    writes, with ``WordTokenizer``. ``load_model`` then reads each artifact in
    its own layout: every tensor must be bit-equal to the trained model's as
    the export rounds it (``exported_weights``), its last-token logits on a
    seeded request must equal that model's within a bf16 ulp of the largest
    (their difference from the model as trained, bf16 copies of the masters
    and LoRA's side path, is printed), and it generates 4 greedy tokens
    through K1-K4. The ``--bits 8`` adapters were trained over the int8 base
    and are merged into the float one, a model that never ran: its logits
    are held to the float stage-2 base with the trained adapters as a side
    path, within 2^-6 of the largest logit (at least two bf16 ulps: the merge
    rounds the adapters' delta into bf16 weights, which the LoRA stage reads
    as one ulp between the merged export and its side path)."""
    import os
    import shutil

    import torch

    from hicom_tpu_torch.api import load_model
    from hicom_tpu_torch.train import cli
    from hicom_tpu_torch.train.dataset import normalize_modal_tag, preprocess_chat
    from hicom_tpu_torch.train.lora import LoRA, apply_lora

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    cfg = serving_config(layers=2)
    t0 = time.perf_counter()
    paths = write_cli_inputs(root, cfg)
    log(f"[cli] wrote the base LLM, the tower, a stage-1 projector and 4 rows of 32-frame videos in "
        f"{time.perf_counter() - t0:.1f} s")
    tok = WordTokenizer(cfg.text_config.vocab_size)
    guide_tok = WordTokenizer(cfg.guide_text_config.vocab_size, cfg.guide_text_config.max_position_embeddings)
    common = ["--model-path", paths["llm"], "--vision-tower", paths["tower"], "--mm-projector-type",
              "local43_global32", "--use-guide", "direct", "--data-path", paths["data"], "--data-folder", root,
              "--num-frames", "32", "--per-device-train-batch-size", "2", "--logging-steps", "1", "--device", "cuda"]
    stage2_bin = os.path.join(root, "stage2", "mm_projector.bin")
    stages = {  # the recipe's flags (scripts/train_3stage_qwen25_7b.sh) per stage, in order
        "stage2": ["--mm-tunable-parts", "mm_projector", "--learning-rate", "1e-4", "--guide-injector-lr", "1e-3",
                   "--pretrain-weights", paths["bin"]],
        "lora": ["--lora-enable", "--learning-rate", "1e-5", "--pretrain-weights", stage2_bin],
        "qlora8": ["--lora-enable", "--bits", "8", "--learning-rate", "1e-5", "--pretrain-weights", stage2_bin],
        "sft": ["--mm-tunable-parts", STAGE3_PARTS, "--learning-rate", "1e-5", "--vision-tower-lr", "2e-6",
                "--pretrain-weights", stage2_bin],
    }
    stages["sft-offload"] = stages["sft"] + ["--offload-optimizer"]  # must equal "sft" bit for bit
    layouts = {"stage2": ("", paths["llm"]), "lora": ("", paths["llm"]), "qlora8": ("", paths["llm"]),
               "sft": ("hf_export", None), "sft-offload": ("hf_export", None)}

    # spliced tokens per step: 2 rows of the longest prompt rounded up to the
    # collator's 64-token bucket, less the sentinel, plus the visual tokens
    with open(paths["data"]) as f:
        convs = [normalize_modal_tag([row["conversations"]], "<video>")[0] for row in json.load(f)]
    prompt_ids, _ = preprocess_chat(convs, tok, "<video>", True)
    bucket = -(-max(map(len, prompt_ids)) // 64) * 64
    request, single = make_requests(cfg, seed=9)
    kept = {}
    for name, flags in stages.items():
        out = os.path.join(root, name)
        args = cli.build_parser().parse_args(common + flags + ["--output-dir", out])
        reset_counts()
        t0 = time.perf_counter()
        with skipped_checkpoint(name == "sft"):
            state = cli.run(args, tok, guide_tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["loss"] for r in rows]
        step_s = rows[1]["time"] - rows[0]["time"]
        spliced = 2 * (bucket - 1 + state.model.visual_token_count(32, "video"))
        log(f"[cli] {card} | {name}: {len(rows)} steps in {wall:.1f} s (model set-up, data and export included), "
            f"losses {losses} | step 2 {step_s * 1e3:.1f} ms (host clock between metrics rows, its batch read and "
            f"collated) | {spliced / step_s:.1f} spliced tokens/s | peak memory {peak_gb:.2f} GB")
        if len(losses) != 2 or not all(np.isfinite(losses)):
            raise AssertionError(f"[cli] {name}: expected 2 finite losses, got {losses}")
        kept[name] = losses
        shutil.rmtree(os.path.join(out, "checkpoints"), ignore_errors=True)  # sft-offload's: 19 GB
        if name == "sft-offload":
            from hicom_tpu_torch.weights import load_hf_state_dict

            with open(os.path.join(root, "sft", "metrics.jsonl")) as f:
                want_losses = [json.loads(line)["loss"] for line in f]
            got_sd, want_sd = (load_hf_state_dict(os.path.join(root, d, "hf_export")) for d in (name, "sft"))
            differ = [k for k in want_sd if not torch.equal(got_sd[k], want_sd[k])]
            log(f"[cli] sft-offload against sft: losses {losses} / {want_losses}, {len(differ)} of {len(want_sd)} "
                "hf_export tensors differ")
            if losses != want_losses or differ or set(got_sd) != set(want_sd):
                raise AssertionError(f"[cli] --offload-optimizer changed the stage: {differ[:3]}")
            del got_sd, want_sd
        raw = last_logits(state.model, request)
        if name == "qlora8":
            # trained over the int8 base: the export merges into the float base
            # (the stage-2 artifact), which is held to that base with the
            # trained adapters as a side path
            base = load_model(os.path.join(root, "stage2"), model_base=paths["llm"], device="cuda")
            adapters = state.lora.adapters()
            expected = apply_lora(base.model.state_dict(), adapters, alpha=args.lora_alpha, rank=args.lora_r)
            side = LoRA(adapters, args.lora_alpha, args.lora_r).attach(base.model)
            want = last_logits(base.model, request)
            side.detach()
            del base, side, adapters
        else:
            expected = exported_weights(name, state, args)
        if name in ("lora", "qlora8"):
            state.lora.detach()
        if name != "qlora8":
            state.model.load_state_dict(expected)
            want = last_logits(state.model, request)
        del state
        torch.cuda.empty_cache()

        sub, base = layouts[name]
        hc = load_model(os.path.join(out, sub), model_base=base, device="cuda")
        loaded = hc.model.state_dict()
        differ = [n for n, v in expected.items() if not torch.equal(loaded[n], v.to(loaded[n].device))]
        del expected, loaded
        got = last_logits(hc.model, request)
        scale = want.abs().max().item()
        tol = (2**-6 if name == "qlora8" else 2**-8) * scale
        err, raw_err = (got - want).abs().max().item(), (got - raw).abs().max().item()
        reset_counts()
        ids = hc.generate(**single, max_new_tokens=4)
        launches = {n: f.launches for n, f in counters().items()}
        held = "the float base with the side-path adapters" if name == "qlora8" else "that model's"
        log(f"[cli] {name}: load_model({'/'.join(filter(None, (name, sub)))}{', model_base' if base else ''}): "
            f"{len(differ)} tensors differ from the trained ones as exported; last-token logits vs {held}: "
            f"max_abs_err {err:.3g} (tol {tol:.3g}, max |logit| {scale:.3g}), vs the model as trained "
            f"(bf16 copies{', side-path adapters' if 'lora' in name else ''}{', int8 base' if name == 'qlora8' else ''}"
            f"): {raw_err:.3g}; 4 greedy ids "
            f"{ids.tolist()}; launches {launches}")
        if differ or not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"[cli] {name}: the loaded artifact is not the trained model (e.g. {differ[:3]})")
        if min(launches.values()) <= 0 or ids.shape != (1, 4):
            raise AssertionError(f"[cli] {name}: generation did not run through K1-K4 ({launches}, {ids.shape})")
        del hc
        torch.cuda.empty_cache()
    # [mesh-cli] trains stage 2 again on these files, then removes them
    return dict(root=root, paths=paths, cfg=cfg, flags=common + stages["stage2"], losses=kept["stage2"])


def write_hf_tokenizer(path: str, tok, texts):
    """A WordLevel tokenizer for ``transformers.AutoTokenizer`` that gives
    ``tok``'s (a ``WordTokenizer``'s) ids for every whitespace-separated word
    of ``texts``, with its chat template, padding id 0 and, for a guide
    tokenizer, its padded length and no attention mask (``tok`` returns
    none)."""
    import os

    from tokenizers import Tokenizer, models, pre_tokenizers

    words = {"<pad>": 0}
    for text in texts:
        for w in text.split():
            words.setdefault(w, tok.ids(w)[0])
    words.setdefault("<unk>", 1)
    used = set(words.values())
    words.update({f"<unused{i}>": i for i in range(max(used) + 1) if i not in used})  # a vocabulary without holes
    tk = Tokenizer(models.WordLevel(words, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tk.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>", "pad_token": "<pad>",
                   "model_max_length": tok.max_length, "model_input_names": ["input_ids"],
                   "chat_template": "{% for m in messages %}<|{{ m['role'] }}|> {{ m['content'] }} <|end|> {% endfor %}"
                                    "{% if add_generation_prompt %}<|assistant|> {% endif %}"}, f)


def mesh_cli_phase(card: str, cli: dict):
    """[mesh-cli]: [cli]'s stage 2 again, on its files, through ``python -m
    torch.distributed.run --standalone --nproc_per_node 1 -m
    hicom_tpu_torch.train.cli ... --dp 1 --fsdp 1 --tp 1`` (a one-rank NCCL
    group, the mesh path). The CLI reads its tokenizers with
    ``transformers.AutoTokenizer``, so the phase first writes, beside the
    base LLM and the tower, WordLevel tokenizers that give [cli]'s
    ``WordTokenizer`` ids, and holds the port's collated batches from both to
    each other. The run's ``metrics.jsonl`` losses must equal [cli]'s stage-2
    losses bit for bit, and its ``mm_projector.bin`` must load through
    ``load_model`` with the tensors of [cli]'s. The kernels launch in the
    rank process, whose counts this process cannot read ([mesh-train] counts
    the mesh path's)."""
    import os
    import shutil

    import torch

    from hicom_tpu_torch.api import load_model
    from hicom_tpu_torch.data.processor import SiglipImagePreprocessor
    from hicom_tpu_torch.train import cli as train_cli
    from hicom_tpu_torch.train.dataset import Collator, SupervisedDataset, iter_batches

    root, paths, cfg = cli["root"], cli["paths"], cli["cfg"]
    try:
        from transformers import AutoTokenizer

        tok = WordTokenizer(cfg.text_config.vocab_size)
        guide_tok = WordTokenizer(cfg.guide_text_config.vocab_size, cfg.guide_text_config.max_position_embeddings)
        with open(paths["data"]) as f:
            rows = json.load(f)
        texts = [m["value"].replace("<video>", " ") for r in rows for m in r["conversations"]]
        write_hf_tokenizer(paths["llm"], tok, texts + ["<|user|> <|assistant|> <|end|> <|system|>"])
        write_hf_tokenizer(paths["tower"], guide_tok, texts)
        hf, hf_guide = AutoTokenizer.from_pretrained(paths["llm"]), AutoTokenizer.from_pretrained(paths["tower"])
        args = train_cli.build_parser().parse_args(cli["flags"] + ["--output-dir", os.path.join(root, "unused")])
        dargs = train_cli.data_arguments(args, train_cli.build_config(args))
        proc = SiglipImagePreprocessor(size=(cfg.vision_config.image_size,) * 2)
        batches = [list(iter_batches(SupervisedDataset(t, dargs, proc), Collator(t, dargs, g), 2, seed=args.seed))
                   for t, g in ((tok, guide_tok), (hf, hf_guide))]
        same = len(batches[0]) == len(batches[1]) > 0 and all(
            a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a if isinstance(a[k], np.ndarray))
            for a, b in zip(*batches))
        if not same:
            raise AssertionError("[mesh-cli] the written tokenizers do not give WordTokenizer's batches")
        out = os.path.join(root, "mesh-stage2")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
               "-m", "hicom_tpu_torch.train.cli", *cli["flags"], "--output-dir", out, "--dp", "1", "--fsdp", "1",
               "--tp", "1"]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                             timeout=600)
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"[mesh-cli] torchrun exited {run.returncode}: {run.stderr[-3000:]}")
        with open(os.path.join(out, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        said = [line for line in run.stdout.splitlines() if line.startswith(("total steps", "step "))]
        got = torch.load(os.path.join(out, "mm_projector.bin"), weights_only=True)
        want = torch.load(os.path.join(root, "stage2", "mm_projector.bin"), weights_only=True)
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        hc = load_model(out, model_base=paths["llm"], device="cuda")
        loaded = hc.model.state_dict()
        not_loaded = [k for k, v in got.items() if not torch.equal(loaded[k].cpu(), v.to(loaded[k].dtype))]
        log(f"[mesh-cli] {card} | torchrun --nproc_per_node 1, --dp 1 --fsdp 1 --tp 1 (NCCL): stage 2 in {wall:.1f} s "
            f"(process start, model set-up, data and export included); rank 0 printed {said}; losses {losses} "
            f"against [cli]'s {cli['losses']}; mm_projector.bin: {len(differ)} of {len(want)} tensors differ from "
            f"[cli]'s, {len(not_loaded)} differ after load_model")
        if losses != cli["losses"] or differ or set(got) != set(want) or not_loaded:
            raise AssertionError(f"[mesh-cli] the mesh path's stage 2 differs from [cli]'s: losses {losses}, "
                                 f"tensors {differ[:3]}, {not_loaded[:3]}")
        del hc, loaded
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# [bench]: each mode of ``python3 -m hicom_tpu_torch.bench`` the phase runs, its flags, and the kernel
# wrappers whose launches must be positive over its timed groups
PREFILL_KERNELS = ("fullblock_attention", "flash_forward", "fused_tile_attention")
# each mode at its widths with the tower and decoder cut to BENCH_LAYERS layers, the four processes at once: the
# smoke checks that every mode runs and reports sanely, its numbers are no measurement (the bench's measurements
# run one mode at a time at full depth, scripts/torch_bench_modes.py)
BENCH_LAYERS = 4
BENCH_MODES = (
    ("default", ["--iters", "8", "--iters-bf16", "4"], PREFILL_KERNELS),
    ("decode", ["--decode"], ("flash_decode",)),
    ("train", ["--train", "--iters", "4"], ("flash_backward",)),
    ("from-disk", ["--from-disk", "--iters", "4"], PREFILL_KERNELS),
)


def bench_phase(card: str):
    """[bench]: the port's bench (``hicom_tpu_torch/bench.py``) at full width,
    its tower and decoder cut to ``BENCH_LAYERS`` layers (``--layers``), in a
    subprocess per mode, the four started together (the kernels already built
    under ``build/kernels/``; each mode's cut model takes under 10 GB): its
    last JSON line must name this card, carry a positive value, every MFU in
    (0, 100], a finite train loss, both arms in the default mode, and positive
    launch counts of the mode's kernels."""
    import os

    import torch

    torch.cuda.empty_cache()
    kind = torch.cuda.get_device_name(0)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    # output to files, not pipes: a full pipe would stall a mode until the phase reads it
    with contextlib.ExitStack() as stack:
        files = [(stack.enter_context(tempfile.TemporaryFile("w+")), stack.enter_context(tempfile.TemporaryFile("w+")))
                 for _ in BENCH_MODES]
        procs = [subprocess.Popen([sys.executable, "-m", "hicom_tpu_torch.bench", "--layers", str(BENCH_LAYERS)]
                                  + flags, cwd=root, stdout=out, stderr=err)
                 for (_, flags, _), (out, err) in zip(BENCH_MODES, files)]
        try:
            ends = []
            for proc in procs:
                proc.wait(timeout=600)
                ends.append(time.perf_counter() - t0)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        outs = []
        for (out, err), proc, seconds in zip(files, procs, ends):
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read(), proc.returncode, seconds))
    for (label, flags, kernels), (stdout, stderr, code, seconds) in zip(BENCH_MODES, outs):
        if code != 0:
            raise AssertionError(f"[bench] {label} exited {code}: {stderr[-4000:]}")
        line = [ln for ln in stdout.splitlines() if ln.startswith("{")][-1]
        log(f"[bench] {card} | {label} ({' '.join(flags)}), done {seconds:.1f} s after the start: {line}")
        res = json.loads(line)
        detail = res["detail"]
        mfus = [detail[k] for k in ("mfu_pct", "bf16_mfu_pct") if k in detail]
        faults = []
        if detail["device"]["kind"] != kind:
            faults.append(f"device {detail['device']['kind']!r}")
        if res["value"] is None or res["value"] <= 0:
            faults.append(f"value {res['value']}")
        if not all(m is not None and 0 < m <= 100 for m in mfus):
            faults.append(f"MFU {mfus}")
        if not np.isfinite(detail.get("loss", 0.0)):
            faults.append(f"loss {detail['loss']}")
        if label == "default" and "bf16_frames_per_sec" not in detail:
            faults.append("no bf16 arm")
        for arm in ("kernel_launches", "bf16_kernel_launches"):
            if arm in detail and min(detail[arm][k] for k in kernels) <= 0:
                faults.append(f"{arm} {detail[arm]}")
        if faults:
            raise AssertionError(f"[bench] {label}: " + "; ".join(faults))


# both stages' learning rate in [closed-loop]: the reference recipe's for the
# decoder (stage 3). With the norms at 1, stage 2's loss falls from about 13
# to 0.03 in 3 steps at 1e-5, reaches 0.0000 after one step at 1e-4 and
# above, and takes 7 steps at 3e-6 (on the H100; PERF.md)
LOOP_LR = 1e-5
LOOP_EPOCHS = 12  # stage 2's epochs (one step each: 12 rows at batch 8)
LOOP_MODES = ["fp", "int8_weight_only", "serving_default"]


def closed_loop_phase(card: str):
    """[closed-loop]: the port's selftest loop (``hicom_tpu_torch.selftest.run``)
    at the width of HICom-7B with 2 tower and 2 decoder layers, in bf16, 8
    frames, on the card: the base LLM and tower directories written by the
    port (``write_base_dirs``, seeded weights, the norms at 1), the selftest's WordLevel
    vocabulary padded with filler words to the model's 152,064 ids (its eos
    ``</s>``, id 2), the selftest's 8 images and 4 mp4s (cv2); stage 1
    (projector, 2 steps) and stage 2 (projector and decoder, ``LOOP_EPOCHS``
    steps, batch 8) through ``train.cli.main`` at ``LOOP_LR``; the stage-2
    ``hf_export`` reloaded by ``model_init`` and run through the port's
    eval runner on the mini Video-MME (parquet: the card has pyarrow; 2
    videos, 4 questions, each with and without subtitles) and scored; then
    the same under ``LOOP_MODES`` with each mode's greedy-token agreement
    with fp. Fails unless the accuracy is at least 75.0 over at least 4
    questions (chance 25.0), every mode scores the fp accuracy, stage 2's
    last loss is below its first, and K1-K6 each launched in the phase. Then
    the eval runner once more over the same export with ``--dtype float32``
    (:func:`fp32_runner_call`). Returns the phase's launches (the fp32 call's
    apart)."""
    import dataclasses
    import os
    import shutil

    import pyarrow
    import torch

    from hicom_tpu_torch import selftest

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_loop")
    shutil.rmtree(root, ignore_errors=True)
    cfg = serving_config(layers=2)
    cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, eos_token_id=2))
    llm, tower = os.path.join(root, "qwen2.5-7b-width"), os.path.join(root, "siglip-so400m-width")
    t0 = time.perf_counter()
    reset_counts()
    write_base_dirs(llm, tower, cfg, seed=13, norms_at_one=True)  # the state dict it returns is dropped here
    torch.cuda.empty_cache()
    selftest._write_wordlevel_tokenizer(llm, selftest.WORDS, vocab_size=cfg.text_config.vocab_size)
    out = selftest.run(os.path.join(root, "loop"), epochs=LOOP_EPOCHS, num_frames=8, quant_modes=LOOP_MODES,
                       device="cuda", dtype="bfloat16", learning_rate=LOOP_LR, logging_steps=1, assets=(llm, tower))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters(train=True).items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stages = {}
    for name, rows in out["metrics"].items():
        losses = [r["loss"] for r in rows]
        step_ms = (rows[-1]["time"] - rows[0]["time"]) / (len(rows) - 1) * 1e3 if len(rows) > 1 else float("nan")
        stages[name] = losses
        log(f"[closed-loop] {card} | {name}: {len(rows)} steps, {step_ms:.1f} ms a step after the first (host "
            f"clock between metrics rows), loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    sweep = out["quant_sweep"]
    modes = " | ".join(f"{m} {r['videomme_accuracy']:.1f} (agreement {r['token_agreement']})" for m, r in sweep.items())
    log("[closed-loop] loss curve: " + " | ".join(f"{n} " + " ".join(f"{x:.4f}" for x in v) for n, v in stages.items()))
    log(f"[closed-loop] {card} | accuracy {out['videomme_accuracy']:.1f} over {out['n_questions']} questions "
        f"(chance {out['chance']}), layout videomme parquet (pyarrow {pyarrow.__version__}) | modes: {modes} | "
        f"lr {LOOP_LR}, {LOOP_EPOCHS} epochs | launches {launches} | peak memory {peak_gb:.2f} GB | "
        f"{seconds:.1f} s")
    if not (out["videomme_accuracy"] >= 75.0 and out["n_questions"] >= 4):
        raise AssertionError(f"[closed-loop] the loop did not learn its answer: {out['report']}")
    if any(r["videomme_accuracy"] != sweep["fp"]["videomme_accuracy"] for r in sweep.values()):
        raise AssertionError(f"[closed-loop] a serving mode scored other than fp: {sweep}")
    if not stages["stage2"][-1] < stages["stage2"][0]:
        raise AssertionError(f"[closed-loop] stage 2's loss did not fall: {stages['stage2']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"[closed-loop] a kernel never launched in the loop: {launches}")
    fp32_runner_call(card, os.path.join(root, "loop"), out["artifacts"]["hf_export"])
    shutil.rmtree(root, ignore_errors=True)
    return launches


def fp32_runner_call(card: str, workdir: str, hf_export: str):
    """[closed-loop]'s fp32 call: the port's eval runner over the stage-2
    export with ``--dtype float32`` on the mini Video-MME the loop scored
    (``selftest.build_mini_videomme`` writes the same files again). It must
    score at least 75.0, as the bf16 call does, launch K1, K2 and K4 (fp32
    instances) and take each decode step to the plain path by K3's contract
    (counted, then reset: every other call of the phase holds it at 0)."""
    import os

    import torch

    from hicom_tpu_torch import selftest
    from hicom_tpu_torch.eval import scorers
    from hicom_tpu_torch.eval.common import merge_chunked_videomme
    from hicom_tpu_torch.eval.runner import main as runner_main
    from hicom_tpu_torch.ops.cuda_build import plain_route

    if any(plain_routes().values()):
        raise AssertionError(f"[closed-loop] bf16 calls went to the plain path: {plain_routes()}")
    t0 = time.perf_counter()
    qf, vids, subs = selftest.build_mini_videomme(workdir, n_videos=2)
    answer = os.path.join(workdir, "eval_fp32", "preds.json")
    fns = counters()
    before = {n: f.launches for n, f in fns.items()}
    runner_main(selftest._runner_argv(hf_export, qf, vids, subs, answer, DEVICE, "float32"))
    torch.cuda.synchronize()
    launched = {n: f.launches - before[n] for n, f in fns.items()}
    k3_plain = plain_routes()["K3"]
    plain_route.reset()
    report = scorers.score_videomme(merge_chunked_videomme([answer]), ["short"], skip_missing=True)
    log(f"[closed-loop] {card} | eval runner --dtype float32 over the stage-2 export: accuracy "
        f"{report['overall']:.1f} | launches {launched} | K3 plain-route calls {k3_plain} | "
        f"{time.perf_counter() - t0:.1f} s")
    if not report["overall"] >= 75.0:
        raise AssertionError(f"[closed-loop] the fp32 runner call scored {report['overall']}: {report}")
    if min(launched[n] for n in ("fullblock_attention", "flash_forward", "fused_tile_attention")) <= 0 \
            or launched["flash_decode"] or k3_plain <= 0:
        raise AssertionError(f"[closed-loop] the fp32 runner call did not take the fp32 kernels: {launched}, "
                             f"K3 plain {k3_plain}")


# ---------------------------------------------------------------------------
# The quantized serving configuration from raw frames, and QLoRA
# ---------------------------------------------------------------------------

DEVICE = "cuda"  # the device the phases build on (a CPU rehearsal points it at "cpu")


def with_mask(req):
    """A request with an all-true attention mask when it has none."""
    if "attention_mask" in req:
        return req
    return dict(req, attention_mask=np.ones(req["input_ids"].shape, bool))


def raw_videos(n: int, frames: int = 32, hw=(360, 640), seed: int = 20):
    """``n`` seeded uint8 videos of ``frames`` decoded frames each, as
    ``process_video(processor=None)`` hands them over: (t, h, w, 3)."""
    from hicom_tpu_torch.data.video import process_video

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        coarse = rng.integers(0, 256, (frames, hw[0] // 8, hw[1] // 8, 3)).astype(np.float32)
        video = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
        video = np.clip(video + rng.normal(0, 10, video.shape), 0, 255).astype(np.uint8)
        out.append(process_video(video, None, num_frames=None))
    return out


def quant_ops_checks(card: str):
    """[quant-ops]: the int8 routes at the main paths' shapes. ``int8_matmul``
    (``torch._int_mm``) at the tower MLP (23,328 x 1152 -> 4304) and at decode
    (1 and 2 rows, padded to 17) is held bit-equal on the int32 sums to the
    exact float64 product of the same codes on the card; ``QuantLinear`` and
    ``QuantLinear4`` against ``F.linear`` over their dequantized weight (the
    kernels' agreement rule); the device preprocess of 32 frames of 360x640
    against the CPU's run of the same frames. Each line gives its time beside
    ``torch.matmul`` in bf16 at the same shape."""
    import torch
    from torch.nn import functional as F

    from hicom_tpu_torch.data.processor import SiglipImagePreprocessor
    from hicom_tpu_torch.data.video import process_video
    from hicom_tpu_torch.models import quant as Q
    from hicom_tpu_torch.ops.preprocess import DeviceSiglipPreprocessor

    dev = DEVICE
    gen = torch.Generator(dev).manual_seed(30)
    for rows, k, n, what in ((23328, 1152, 4304, "tower fc1"), (23328, 4304, 1152, "tower fc2"),
                             (1, 3584, 18944, "decode gate/up, 1 row"), (2, 3584, 18944, "decode gate/up, 2 rows"),
                             (2, 18944, 3584, "decode down, 2 rows")):
        x = torch.randn(rows, k, generator=gen, device=dev, dtype=torch.bfloat16)
        w = torch.randn(n, k, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
        xq, sx = Q.quantize_rows(x)
        wq, ws = Q.quantize_int8_weight(w)
        acc = Q.int8_matmul(xq, wq)
        exact = (xq.double() @ wq.double().t()).to(torch.int32)
        equal = torch.equal(acc, exact)
        lin = Q.W8A8Linear(k, n, False, torch.bfloat16).to(dev)
        lin.weight_q, lin.weight_scale = wq, ws
        ms_int, ms_bf16 = cuda_ms(lambda: Q.int8_matmul(xq, wq)), cuda_ms(lambda: torch.matmul(x, w.t()))
        ms_lin = cuda_ms(lambda: lin(x))
        log(f"[quant-ops] {card} | int8_matmul {what} ({rows} x {k} -> {n}): int32 sums bit-equal to the exact "
            f"product {equal} | _int_mm {ms_int:.4f} ms, W8A8Linear (quantize + _int_mm + epilogue) {ms_lin:.4f} ms,"
            f" bf16 torch.matmul {ms_bf16:.4f} ms")
        if not equal:
            raise AssertionError(f"[quant-ops] int8_matmul {what} differs from the exact product")
        del x, w, xq, wq, acc, exact, lin
    for cls, rows, k, n in ((Q.QuantLinear, 2, 3584, 18944), (Q.QuantLinear4, 2, 3584, 18944),
                            (Q.QuantLinear, 743, 3584, 18944), (Q.QuantLinear4, 1486, 3584, 18944)):
        lin = cls(k, n, False, torch.bfloat16).to(dev)
        w = torch.randn(n, k, generator=gen, device=dev, dtype=torch.bfloat16) * 0.02
        lin.set_weight(w)
        x = torch.randn(rows, k, generator=gen, device=dev, dtype=torch.bfloat16)
        if cls is Q.QuantLinear:
            deq = lin.weight_q.to(torch.bfloat16)
            ref = lambda: F.linear(x, deq) * lin.weight_scale.to(torch.bfloat16)  # noqa: E731
        else:
            deq = Q.nf4_dequant(lin.weight_nf4, lin.weight_scale, torch.bfloat16)
            ref = lambda: F.linear(x, deq)  # noqa: E731
        with torch.no_grad():
            err, worst, _, _ = agreement(lin(x), ref())
            ms, ms_bf16 = cuda_ms(lambda: lin(x)), cuda_ms(lambda: torch.matmul(x, w.t()))
        log(f"[quant-ops] {card} | {cls.__name__} ({rows} x {k} -> {n}) vs F.linear over its dequantized weight: "
            f"max_abs_err {err:.3g}, worst err/tol {worst:.3f} | {ms:.4f} ms (dequantize + bf16 product), bf16 "
            f"torch.matmul {ms_bf16:.4f} ms")
        if worst > 1:
            raise AssertionError(f"[quant-ops] {cls.__name__} disagrees with its dequantized product")
        del lin, w, x, deq
    (video,) = raw_videos(1)
    host = DeviceSiglipPreprocessor(device="cpu")(video)["pixel_values"]
    proc = DeviceSiglipPreprocessor(device=dev)
    got = proc(video)["pixel_values"]
    diff = (got.cpu() - host).abs()
    off = (diff > 1e-6).float().mean().item()
    ms = cuda_ms(lambda: proc(video))
    t0 = time.perf_counter()
    process_video(video, SiglipImagePreprocessor(size=(384, 384)), num_frames=None)
    host_ms = 1e3 * (time.perf_counter() - t0)
    log(f"[quant-ops] {card} | device preprocess, 32 frames 360x640 uint8 -> (32, 3, 384, 384) fp32: "
        f"max |diff| vs the CPU run {diff.max().item():.4g} (one uint8 level = {2 / 255:.4g}), pixels off "
        f"{off:.2e} (tol 1e-3) | {ms:.3f} ms with the upload (TF32 allowed: "
        f"{torch.backends.cuda.matmul.allow_tf32}); the host SiglipImagePreprocessor {host_ms:.1f} ms")
    if diff.max().item() > 2 / 255 * 1.001 or off > 1e-3:
        raise AssertionError("[quant-ops] the device preprocess disagrees with the CPU's")
    torch.cuda.empty_cache()


def quant_config(cfg, text=None, vision=None):
    import dataclasses

    return cfg.replace(text_config=dataclasses.replace(cfg.text_config, quantization=text),
                       vision_config=dataclasses.replace(cfg.vision_config, quantization=vision))


def quant_plain_parity(label: str, text: str, vision=None):
    """The gate of a quantized serving phase: at 7B width with 2 tower and 2
    decoder layers, the card's last-token logits against the plain path's on
    the card (:func:`plain_path`) on the same weights (a static model
    calibrated first, by its first request): an 8-frame request, the rule of
    the 2-layer kernel-vs-plain check (5% of the largest logit). This gate
    shares the quantized linears with the path under test: [quant-ops] holds
    their products to the CPU's exact ones, and [model-init] holds the int8
    decoder (``load_8bit``) to the CPU's string over a whole generation. A CPU
    copy here took 10.6-11.2 s a phase on the host of an H100 80GB HBM3
    machine, cut to keep the run in its time."""
    import torch

    from hicom_tpu_torch.api import HICom, build_model

    cfg = quant_config(serving_config(layers=2), text, vision)
    model = build_model(cfg, device=DEVICE, seed=2)
    _, single = make_requests(cfg, seed=3)
    single = with_mask(dict(single, frames=single["frames"][:, :8]))
    hc = HICom(config=cfg, model=model, eos_token_id=cfg.text_config.eos_token_id, cache_len=1024)
    hc.generate(**{k: v for k, v in single.items() if k != "attention_mask"}, max_new_tokens=1)
    got = last_logits(model, single)
    t0 = time.perf_counter()
    with plain_path():
        ref = last_logits(model, single)
    plain_s = time.perf_counter() - t0
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    log(f"[{label}] 2-layer last-token logits, kernel vs plain path on the card on the same weights: max_abs_err "
        f"{err:.3g} (tol {0.05 * scale:.3g}, max |logit| {scale:.3g}), top-1 {int(got.argmax())} vs "
        f"{int(ref.argmax())}, plain path {plain_s:.1f} s")
    if not (torch.isfinite(got).all() and scale > 0 and err <= 0.05 * scale):
        raise AssertionError(f"[{label}] the card's quantized logits disagree with the plain path")
    del model, hc
    torch.cuda.empty_cache()


def decoder_bytes(model):
    """(bytes of the decoder layers' tensors, bytes of embeddings + head)."""
    layers = sum(t.numel() * t.element_size() for n, t in model.state_dict().items() if n.startswith("model.layers."))
    ends = sum(t.numel() * t.element_size() for n, t in model.state_dict().items()
               if n.startswith(("model.embed_tokens", "lm_head", "model.norm")))
    return layers, ends


def serve_quant_phase(card: str, label: str, text: str, vision=None):
    """[serve-int8] / [serve-w8a8]: HICom-7B at full width and depth with the
    decoder (and tower) quantized, built from the seeded float weights of
    [slice], fed 3 raw uint8 videos of 32 frames of 360x640 through
    ``process_video(processor=None)`` and ``DeviceSiglipPreprocessor`` for
    [slice]'s 3 requests; a static model calibrates on its first request.
    Prints the stage times, TTFT, decode rate, peak memory and decoder bytes,
    and (int8) the bf16 model's logits beside these. Returns the launches."""
    import torch

    from hicom_tpu_torch.api import HICom, build_model
    from hicom_tpu_torch.data.processor import SiglipImagePreprocessor
    from hicom_tpu_torch.data.video import process_video
    from hicom_tpu_torch.models import quant as Q
    from hicom_tpu_torch.ops.preprocess import DeviceSiglipPreprocessor

    cfg = quant_config(serving_config(), text, vision)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    layer_b, end_b = decoder_bytes(model)
    log(f"[{label}] built HICom-7B, decoder {text}, tower {vision or 'bf16'}, from the seeded float weights in "
        f"{time.perf_counter() - t0:.1f} s, peak {build_peak:.2f} GB while building | decoder layers "
        f"{layer_b / 1e9:.3f} GB, embeddings + head {end_b / 1e9:.3f} GB")
    hc = HICom(config=cfg, model=model, eos_token_id=cfg.text_config.eos_token_id, cache_len=4096)
    pre = DeviceSiglipPreprocessor(out_dtype=torch.bfloat16, device=hc.device)
    raws = raw_videos(3)
    batch, single = make_requests(cfg)
    pix = lambda i: pre(raws[i])["pixel_values"]  # noqa: E731
    qbatch = dict(batch, frames=None)
    qsingle = dict(single, frames=None)

    def run(req, idx, n):
        frames = torch.stack([pix(i) for i in idx]) if len(idx) > 1 else pix(idx[0])[None]
        return hc.generate(**dict(req, frames=frames), max_new_tokens=n)

    t0 = time.perf_counter()
    run(qsingle, [2], 2)  # warm-up; a static model calibrates here
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fns = counters()
    for f in fns.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out2 = run(qbatch, [0, 1], 16)
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    out1 = run(qsingle, [2], 16)
    t_single = time.perf_counter() - t0
    launches = {name: f.launches for name, f in fns.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{label}] launches over the 3 requests: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"[{label}] the quantized path never launched a kernel: {launches}")
    vocab = cfg.text_config.vocab_size
    for out in (out2, out1):
        if not (out.min() >= 0 and out.max() < vocab):
            raise AssertionError(f"[{label}] generated ids out of range: {out}")
    log(f"[{label}] batch of 2 ids: {out2.tolist()} | single ids: {out1.tolist()}")
    ttfts = []
    for _ in range(2):
        t0 = time.perf_counter()
        run(qsingle, [2], 1)
        ttfts.append(time.perf_counter() - t0)
    decode_tps, stages = stage_breakdown(hc, video_front(hc, single, lambda: pix(2)[None]), label=f"{label}-stages")
    t0 = time.perf_counter()
    process_video(raws[2], SiglipImagePreprocessor(size=(384, 384)), num_frames=None)
    host_ms = 1e3 * (time.perf_counter() - t0)
    log(f"[{label}] {card} | 3 requests (32 raw frames of 360x640 each, 16 new tokens): first request "
        f"{first_s:.2f} s{' (with the calibration)' if text.startswith('w8a8s') else ''}, batch-of-2 request "
        f"{t_batch:.3f} s, single request {t_single:.3f} s | TTFT {min(ttfts) * 1e3:.1f} ms (from uint8 frames on "
        f"the host) | decode {decode_tps:.1f} tokens/s (single stream) | peak memory {peak_gb:.2f} GB | host "
        f"SiglipImagePreprocessor for the same 32 frames {host_ms:.1f} ms")
    ref = BF16_REFERENCE.get("logits")
    if ref is not None:
        got = last_logits(model, with_mask(single)).cpu()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        log(f"[{label}] the single request's last-token logits vs the bf16 model's (the same float weights, "
            f"float frames): top-1 {int(got.argmax())} vs {int(ref.argmax())} (agree "
            f"{bool(got.argmax() == ref.argmax())}), max |diff| / max |logit| {rel:.4f} | vision tower "
            f"{stages['vision tower']:.1f} ms vs bf16 {BF16_REFERENCE['tower_ms']:.1f} ms")
    sites = Q.calibration_sites(model)
    if sites:
        smooth = [m.act_smooth for m in sites.values()]
        folded = sum(int(bool((s != 1).any())) for s in smooth)
        unit = sum(int(bool(m.act_scale == 1)) for m in sites.values())
        log(f"[{label}] calibration: {len(sites)} static sites filled ({unit} left at act_scale 1), "
            f"{folded} took the SmoothQuant fold | vision tower {stages['vision tower']:.1f} ms vs the bf16 "
            f"tower's {BF16_REFERENCE.get('tower_ms', float('nan')):.1f} ms")
        if unit or not (hc.tower_calibrated and hc.decoder_calibrated):
            raise AssertionError(f"[{label}] the first request did not calibrate every static site")
    del model, hc, pre
    torch.cuda.empty_cache()
    quant_plain_parity(label, text, vision)
    return launches


def write_word_tokenizer(path: str, vocab: int, eos: int):
    """A WordLevel tokenizer over the model's whole vocabulary (``w<id>``),
    written with ``tokenizers`` for ``transformers.AutoTokenizer``."""
    import os

    from tokenizers import Tokenizer, models, pre_tokenizers

    words = {"<unk>": 0, "<pad>": 1}
    words.update({f"w{i}": i for i in range(2, vocab)})
    tk = Tokenizer(models.WordLevel(words, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>", "pad_token": "<pad>",
                   "eos_token": f"w{eos}",
                   "chat_template": "{% for m in messages %}w7 {{ m['content'] }} w8 {% endfor %}"
                                    "{% if add_generation_prompt %}w9{% endif %}"}, f)


# (flag, load_model's arguments, whether the card's string is held to the CPU's; else to the plain path's on
# the card, on the same loaded model). Each CPU run took 10.9-21.9 s on the host of an H100 80GB HBM3 machine
# where the whole run read 1,200.4 s by its clock with all of them: only load_8bit's stays, so that one quantized decoder is held to an
# independent path over a whole generation (quantize-on-load, int8 linears, tower and attention all on the CPU).
MODEL_INIT_FLAGS = (("load_8bit", dict(load_8bit=True), True), ("load_4bit", dict(load_4bit=True), False),
                    ("dec_quant=w8a8_mlp", dict(dec_quant="w8a8_mlp"), False),
                    ("dec_quant=w8a8s", dict(dec_quant="w8a8s"), False),
                    ("load_w8a8_tower=True", dict(load_w8a8_tower=True), False),
                    ("load_w8a8_tower=w8a8s_mlp", dict(load_w8a8_tower="w8a8s_mlp"), False))


def model_init_phase(card: str):
    """[model-init]: at 7B width with 2 tower and 2 decoder layers (8 frames),
    the port exports a seeded checkpoint (fp16 safetensors, a tower directory
    for its geometry) and a WordLevel tokenizer over its vocabulary, under
    ``build/``; then ``model_init(..., device_preprocess=True)`` + ``mm_infer``
    on raw uint8 frames runs under each quantization flag on the card, and
    again on the CPU (``device="cpu"``, the plain path) for ``load_8bit`` or
    under :func:`plain_path` on the card for the others (see
    ``MODEL_INIT_FLAGS``); the two strings must be equal. Returns the
    launches on the card."""
    import dataclasses
    import os
    import shutil

    import torch

    from hicom_tpu_torch.api import build_model, mm_infer, model_init
    from hicom_tpu_torch.weights import export_hf_checkpoint

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_model_init")
    shutil.rmtree(root, ignore_errors=True)
    tower, ckpt = os.path.join(root, "siglip-so400m-2-layers"), os.path.join(root, "hicom-7b-width-2-layers")
    os.makedirs(tower)
    cfg = serving_config(layers=2).replace(num_frames=8, mm_vision_tower=tower)
    with open(os.path.join(tower, "config.json"), "w") as f:
        json.dump({"model_type": "siglip", "vision_config": dataclasses.asdict(cfg.vision_config),
                   "text_config": dataclasses.asdict(cfg.guide_text_config)}, f)
    model = build_model(cfg, device=DEVICE, seed=11)
    export_hf_checkpoint(model.state_dict(), cfg, ckpt)
    del model
    torch.cuda.empty_cache()
    tc = cfg.text_config
    write_word_tokenizer(ckpt, tc.vocab_size, tc.eos_token_id)
    (video,) = raw_videos(1, frames=8, seed=21)
    gids = np.random.default_rng(22).integers(0, cfg.guide_text_config.vocab_size, (1, 64))
    question = "w100 w2000 w30000 w151000"
    total = {}
    for name, flags, on_cpu in MODEL_INIT_FLAGS:
        t0 = time.perf_counter()
        hc, proc, tok = model_init(ckpt, device_preprocess=True, device=DEVICE, **flags)
        pixels = proc["video"](video)
        reset_counts()
        card_str = mm_infer(pixels, question, hc, tok, guide_ids=gids, max_new_tokens=6)
        launches = {n: f.launches for n, f in counters().items()}
        for n, v in launches.items():
            total[n] = total.get(n, 0) + v
        card_s, t0 = time.perf_counter() - t0, time.perf_counter()
        if on_cpu:
            del hc, proc
            torch.cuda.empty_cache()
            hc, proc, tok = model_init(ckpt, device_preprocess=True, device="cpu", **flags)
            ref, where = mm_infer(proc["video"](video), question, hc, tok, guide_ids=gids, max_new_tokens=6), "CPU"
        else:
            with plain_path():
                ref, where = mm_infer(pixels, question, hc, tok, guide_ids=gids, max_new_tokens=6), "the card's"
        log(f"[model-init] {name}: card {card_str!r} ({card_s:.1f} s with the load), {where} plain path {ref!r} "
            f"({time.perf_counter() - t0:.1f} s), launches on the card {launches}")
        del hc, proc
        torch.cuda.empty_cache()
        if not card_str or card_str != ref:
            raise AssertionError(f"[model-init] {name}: the card's string differs from the {where} plain path's "
                                 f"(or is empty)")
        if min(launches.values()) <= 0:
            raise AssertionError(f"[model-init] {name}: mm_infer did not run through K1-K4: {launches}")
    shutil.rmtree(root, ignore_errors=True)
    return total


def stage3_qlora_phase(card: str):
    """[stage3-qlora]: stage 3 with ``--bits 4`` semantics at the full width and
    depth of HICom-7B: the NF4 decoder (quantized linear by linear as its
    seeded float weights are drawn), LoRA r 128 alpha 256 on the seven
    linears, remat, lr 1e-5, 3 steps on the stage-2 batch. The base stays
    bit-identical; each adapter tensor whose last gradient reaches AdamW's
    eps in magnitude moved; the flash backward runs once per decoder layer
    and the forward twice per layer plus once. Prints the peak memory beside
    ``estimate_qlora_memory``."""
    import dataclasses

    import torch

    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.train.lora import estimate_qlora_memory, init_lora_params
    from hicom_tpu_torch.train.train_step import batch_to_device, create_lora_state, make_lora_train_step

    cfg = serving_config()
    cfg = quant_config(cfg.replace(text_config=dataclasses.replace(cfg.text_config, remat=True),
                                   vision_config=dataclasses.replace(cfg.vision_config, remat=True)), "nf4")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEVICE, seed=0)
    lora = init_lora_params(model, rank=128, generator=torch.Generator(DEVICE).manual_seed(0))
    state = create_lora_state(model, lora, alpha=256.0, rank=128, learning_rate=1e-5, total_steps=TRAIN_STEPS + 2)
    del lora
    n_adapter = sum(p.numel() for p in state.lora.parameters())
    base = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    base_bytes = sum(t.numel() * t.element_size() for t in base.values())
    log(f"[stage3-qlora] HICom-7B, NF4 decoder, remat on: {len(state.lora.names)} adapted linears, "
        f"{n_adapter / 1e6:.1f} M adapter parameters (fp32), frozen base {base_bytes / 1e9:.2f} GB")
    base_before = bit_sums(base.items())
    before = {n: p.detach().clone() for n, p in state.lora.named_parameters()}
    batch = batch_to_device(make_train_batch(cfg), torch.device(DEVICE), torch.bfloat16)
    step = make_lora_train_step()
    reset_counts()
    times, metrics, fwd, bwd = run_steps(state, step, batch)
    launches = log_steps("stage3-qlora", card, f"HICom-7B stage 3 QLoRA (NF4 base, r 128, {n_adapter / 1e6:.1f} M "
                         "adapter parameters), remat", model, cfg, batch, times, metrics, fwd, bwd)
    spliced = batch["input_ids"].shape[0] * (batch["input_ids"].shape[1] - 1 + model.visual_token_count(
        cfg.num_frames, "video"))
    est = estimate_qlora_memory(cfg.text_config, bits=4, rank=128, batch_tokens=spliced)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[stage3-qlora] peak memory {peak:.2f} GiB vs estimate_qlora_memory (bits 4, r 128, {spliced} tokens): "
        + ", ".join(f"{k} {v:.2f}" for k, v in est.items() if k.endswith("_gib"))
        + " (the estimate leaves out the towers, the projector and the tower's activations)")
    n_layers = cfg.text_config.num_hidden_layers
    if bwd != [n_layers] * TRAIN_STEPS or fwd != [2 * n_layers + 1] * TRAIN_STEPS:
        raise AssertionError(f"[stage3-qlora] flash backward {bwd}, forward {fwd} per step, not {n_layers} and "
                             f"{2 * n_layers + 1}")
    after = bit_sums(base.items())
    changed = [n for n in base_before if not torch.equal(after[n], base_before[n])]
    eps = state.optimizer.defaults["eps"]
    params = dict(state.lora.named_parameters())
    reach = [n for n, p in params.items() if p.grad is not None and p.grad.abs().max().item() >= eps]
    still = [n for n in reach if torch.equal(params[n].detach(), before[n])]
    if changed or still or not reach:
        raise AssertionError(f"[stage3-qlora] {len(changed)} base tensors changed (e.g. {changed[:3]}), {len(still)} "
                             f"adapter tensors with a gradient >= eps unmoved (e.g. {still[:3]})")
    log(f"[stage3-qlora] checks: {len(base_before)} base tensors bit-identical; {len(reach)} of {len(params)} adapter "
        f"tensors had a gradient >= eps ({eps}) and all moved")
    state.lora.detach()
    del model, state, base, base_before, before, batch, params
    torch.cuda.empty_cache()
    return launches


# the anyres configuration's two requests: (width, height) of each synthetic image, its crops and visual tokens
ANYRES_IMAGES = ((1920, 1080), (1024, 1024))
ANYRES_CROPS = (16, 10)
ANYRES_TOKENS = (7270, 7372)
ANYRES_QUESTION = "describe this picture in detail"


def anyres_images(cfg, seed: int = 30):
    """The two synthetic PNGs (seeded noise at 1920x1080 and 1024x1024),
    written under ``build/`` and cut into crops by ``data/image.process_image``
    with the SigLIP preprocessor, as ``model_init``'s image processor does.
    Returns [(crops (n, 3, 384, 384) float32, (width, height))]."""
    import os
    import shutil

    from PIL import Image

    from hicom_tpu_torch.data.image import process_image
    from hicom_tpu_torch.data.processor import SiglipImagePreprocessor

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_anyres")
    os.makedirs(root, exist_ok=True)
    proc = SiglipImagePreprocessor(size=(cfg.vision_config.image_size,) * 2)
    rng = np.random.default_rng(seed)
    out = []
    for w, h in ANYRES_IMAGES:
        path = os.path.join(root, f"{w}x{h}.png")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
        crops, sizes = process_image(path, proc, cfg.image_aspect_ratio, cfg.image_grid_pinpoints)
        out.append((crops, tuple(sizes[0])))
    shutil.rmtree(root, ignore_errors=True)
    if tuple(c.shape[0] for c, _ in out) != ANYRES_CROPS:
        raise AssertionError(f"the anyres images gave {[c.shape for c, _ in out]} crops, not {ANYRES_CROPS}")
    return out


def anyres_prompt(tok):
    """The prompt ids ``mm_infer`` makes of ANYRES_QUESTION, before its 64-token padding: (1, n)."""
    from hicom_tpu_torch.data.prompts import tokenizer_multimodal_token

    prompt = tok.apply_chat_template([{"role": "user", "content": "<image>\n" + ANYRES_QUESTION}], tokenize=False,
                                     add_generation_prompt=True)
    return np.asarray(tokenizer_multimodal_token(prompt, tok, "<image>", return_tensors="np"))[None]


def anyres_phase(card: str):
    """[anyres]: the reference's llava1.5 anyres configuration at full width
    and depth (``anyres_config``) answers two requests through ``mm_infer(...,
    modal="image", image_size=...)``: the crops of a 1920x1080 and a
    1024x1024 image (16 and 10 crops, 7,270 and 7,372 visual tokens, an
    8,192-slot cache), 16 greedy tokens each. Then TTFT, the stage breakdown
    ([anyres-stages]: crop upload, tower on the crops, merge, projector,
    splice + prefill, decode) and one merge + projector under
    ``set_sync_debug_mode("error")``. Returns the launches of the two requests."""
    import torch

    from hicom_tpu_torch.api import HICom, build_model, mm_infer
    from hicom_tpu_torch.models.anyres import apply_anyres_plan, make_anyres_plan

    cfg = anyres_config()
    images = anyres_images(cfg)
    model = build_model(cfg, device=DEVICE, seed=0)
    hc = HICom(config=cfg, model=model, eos_token_id=cfg.text_config.eos_token_id, cache_len=4096)
    tok = WordTokenizer(cfg.text_config.vocab_size)
    ask = lambda i, n: mm_infer(images[i][0], ANYRES_QUESTION, hc, tok, modal="image",  # noqa: E731
                                image_size=images[i][1], max_new_tokens=n)
    ask(1, 2)  # warm-up
    reset_counts()
    replies, seconds = [], []
    for i in range(len(images)):
        t0 = time.perf_counter()
        replies.append(ask(i, 16))
        seconds.append(time.perf_counter() - t0)
    launches = {name: f.launches for name, f in counters().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[anyres] launches over the 2 requests: {launches}")
    for i, reply in enumerate(replies):
        log(f"[anyres] reply {i} ({len(reply.split())} words): {reply[:120]!r}")
    if not all(replies) or min(launches[n] for n in ("fullblock_attention", "flash_forward", "flash_decode")) <= 0:
        raise AssertionError(f"[anyres] an empty reply, or K1-K3 not launched: {launches}")
    if launches["fused_tile_attention"]:
        raise AssertionError("[anyres] the mean-pool projector launched the tile kernel")

    prompt = anyres_prompt(tok)
    L = max(64, -(-prompt.shape[1] // 64) * 64)  # mm_infer's bucket
    counts, caches = [], []
    for crops, size in images:
        n_vis = hc.encode_anyres(crops, size).shape[0]
        counts.append(n_vis)
        caches.append(hc.cache_len_for(L, n_vis, 16))
    grids = [make_anyres_plan(sz, cfg, cfg.vision_config.image_size)[:2] for _, sz in images]
    log(f"[anyres] visual tokens {counts} (grids {grids}), "
        f"spliced prompts {[L - 1 + n for n in counts]}, KV cache {caches} slots")
    if tuple(counts) != ANYRES_TOKENS or caches != [8192, 8192]:
        raise AssertionError(f"[anyres] {counts} visual tokens and {caches}-slot caches, not {ANYRES_TOKENS} and "
                             "8192")
    ttft = []
    for _ in range(2):
        t0 = time.perf_counter()
        ask(0, 1)
        ttft.append(time.perf_counter() - t0)

    crops, size = images[0]
    plan = make_anyres_plan(size, cfg, cfg.vision_config.image_size)

    def front(mark):
        ids = torch.as_tensor(prompt, device=hc.device)
        pixels = torch.as_tensor(crops, device=hc.device, dtype=torch.bfloat16)
        mark("crop upload")
        feats, _ = model.model.vision_tower.vision_tower(pixels)
        mark(f"tower on the {crops.shape[0]} crops")
        merged = apply_anyres_plan(feats[None], plan)
        mark("merge")
        vis = model.project_merged(merged)
        mark("projector")
        return ids, vis

    decode_tps, _ = stage_breakdown(hc, front, label="anyres-stages")
    anyres_sync_check(model, crops, plan)
    log(f"[anyres] {card} | 2 requests (anyres images {ANYRES_IMAGES[0]} and {ANYRES_IMAGES[1]}, {counts} visual "
        f"tokens, 16 new tokens): {seconds[0]:.3f} s and {seconds[1]:.3f} s | TTFT {min(ttft) * 1e3:.1f} ms "
        f"(first request) | decode {decode_tps:.1f} tokens/s (single stream, {caches[0]}-slot cache) | peak memory "
        f"{peak_gb:.2f} GB")
    del model, hc
    torch.cuda.empty_cache()
    return launches


def anyres_sync_check(model, crops, plan):
    """[anyres-sync]: the merge and the projector of one anyres image
    (``HIComModel.project_anyres``) on its tower features, under
    ``torch.cuda.set_sync_debug_mode("error")``: the plan is host arithmetic,
    so nothing may wait for the device."""
    import torch

    with torch.inference_mode():
        feats, _ = model.model.vision_tower.vision_tower(torch.as_tensor(crops, device=DEVICE, dtype=torch.bfloat16))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            vis = model.project_anyres(feats[None], None, plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        finite = bool(torch.isfinite(vis).all())
    log(f"[anyres-sync] merge + projector {tuple(vis.shape)} under set_sync_debug_mode('error'): no synchronising "
        f"call, finite {finite}")
    if not finite or vis.shape[1] != plan.token_count(has_newline=True):
        raise AssertionError(f"[anyres-sync] {tuple(vis.shape)}, finite {finite}")


def check_moved(label: str, model, trained_before: dict, frozen_before: dict, eps: float = 1e-8):
    """Fails unless every trained tensor whose last gradient reaches AdamW's
    ``eps`` moved (a smaller one may stay put: eps dominates its update, as
    [stage3-sft] allows) and every frozen one kept its bits (``bit_sums``)."""
    import torch

    params = dict(model.named_parameters())
    reach = [n for n in trained_before if params[n].grad is not None and params[n].grad.abs().max().item() >= eps]
    still = [n for n in reach if torch.equal(params[n].detach(), trained_before[n])]
    after = bit_sums((n, params[n]) for n in frozen_before)
    changed = [n for n in frozen_before if not torch.equal(after[n], frozen_before[n])]
    if still or not reach or changed:
        raise AssertionError(f"[{label}] trained tensors with max |grad| >= eps that did not move {still[:3]} (of "
                             f"{len(reach)}); frozen tensors that changed {changed[:3]}")
    log(f"[{label}] checks: {len(frozen_before)} frozen tensors kept their bits; {len(reach)} of "
        f"{len(trained_before)} trained tensors had a gradient >= eps ({eps}) and all moved")


def anyres_train_batch(cfg, plan, seed: int = 0):
    """Two rows of the 1920x1080 plan's crops (seeded pixels): prompts of 64
    and 41 tokens with an <image> sentinel, labels as ``make_train_batch``'s."""
    from hicom_tpu_torch.constants import IGNORE_INDEX

    rng = np.random.default_rng(seed)
    ids = np.zeros((2, 64), np.int64)
    mask = np.zeros((2, 64), bool)
    for i, n in enumerate((64, 41)):
        ids[i, :n] = rng.integers(0, cfg.text_config.vocab_size, (n,))
        ids[i, 5] = -200
        mask[i, :n] = True
    labels = np.where(mask, ids, IGNORE_INDEX)
    labels[:, :8] = IGNORE_INDEX
    size = cfg.vision_config.image_size
    frames = rng.uniform(-1, 1, (2, 1 + plan.nh * plan.nw, 3, size, size)).astype(np.float32)
    return dict(input_ids=ids, attention_mask=mask, labels=labels, frames=frames)


def anyres_train_phase(card: str):
    """[anyres-train]: the projector step of the anyres configuration (the
    pretrain stage of mlp2x_gelu_anyres.sh: the projector trained, tower and
    decoder frozen) at full width and depth with remat, on 2 rows sharing the
    1920x1080 plan (16 crops, 7,333 spliced tokens a row): 3 steps through
    ``make_train_step(modal="image", anyres_plan=plan)``. Returns the launches."""
    import dataclasses

    import torch

    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.models.anyres import make_anyres_plan
    from hicom_tpu_torch.train.optimizer import build_optimizer
    from hicom_tpu_torch.train.train_step import batch_to_device, create_train_state, make_loss_fn, make_train_step

    cfg = anyres_config()
    cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, remat=True),
                      vision_config=dataclasses.replace(cfg.vision_config, remat=True))
    model = build_model(cfg, device=DEVICE, seed=0)
    opt = build_optimizer(model, learning_rate=1e-3, total_steps=TRAIN_STEPS + 2, tunable_parts="mm_projector")
    state = create_train_state(model, opt)
    params = dict(model.named_parameters())
    trained_before = {n: p.detach().clone() for n, p in params.items() if p.requires_grad}
    frozen_before = bit_sums((n, p) for n, p in params.items() if not p.requires_grad)
    plan = make_anyres_plan(ANYRES_IMAGES[0], cfg, cfg.vision_config.image_size)
    batch = batch_to_device(anyres_train_batch(cfg, plan), torch.device(DEVICE), torch.bfloat16)
    step = make_train_step(modal="image", anyres_plan=plan)
    reset_counts()
    times, metrics, fwd, bwd = run_steps(state, step, batch)
    spliced = 2 * (64 - 1 + plan.token_count(has_newline=True))
    launches = log_steps("anyres-train", card, f"anyres projector step ({len(trained_before)} trained tensors, "
                         "remat)", model, cfg, batch, times, metrics, fwd, bwd, spliced=spliced,
                         inputs="{} crops of a {}x{} image".format(1 + plan.nh * plan.nw, *ANYRES_IMAGES[0]))
    n_layers = cfg.text_config.num_hidden_layers
    if bwd != [n_layers] * TRAIN_STEPS or launches["fused_tile_attention"] or launches["flash_decode"]:
        raise AssertionError(f"[anyres-train] flash backward per step {bwd} (not {n_layers}), or a kernel without "
                             f"a backward ran: {launches}")
    check_moved("anyres-train", model, trained_before, frozen_before)
    train_profile("anyres-train", state, step, batch, model.parameters(), lambda: state.optimizer.update(model),
                  loss_fn=make_loss_fn(model, "image", anyres_plan=plan))
    del model, state, opt, params, trained_before, batch
    torch.cuda.empty_cache()
    return launches


def multi_image_batch(cfg, seed: int = 0):
    """Two rows of 2 images each (seeded pixels): prompts of 64 and 41 tokens
    with two <image> sentinels, guide ids, labels as ``make_train_batch``'s."""
    from hicom_tpu_torch.constants import IGNORE_INDEX

    rng = np.random.default_rng(seed)
    ids = np.zeros((2, 64), np.int64)
    mask = np.zeros((2, 64), bool)
    for i, n in enumerate((64, 41)):
        ids[i, :n] = rng.integers(0, cfg.text_config.vocab_size, (n,))
        ids[i, [5, n // 2]] = -200
        mask[i, :n] = True
    labels = np.where(mask, ids, IGNORE_INDEX)
    labels[:, :8] = IGNORE_INDEX
    size = cfg.vision_config.image_size
    gtc = cfg.guide_text_config
    return dict(input_ids=ids, attention_mask=mask, labels=labels,
                frames=rng.uniform(-1, 1, (2, 2, 3, size, size)).astype(np.float32),
                guide_ids=rng.integers(0, gtc.vocab_size, (2, gtc.max_position_embeddings)))


def multi_image_phase(card: str):
    """[multi-image]: HICom-7B's stage 2 (projector and guide injectors
    trained) at full width and depth on rows of 2 images (``image_aspect_ratio
    "pad"``): 3 steps through ``make_train_step(modal="image",
    multi_image=True)``. Returns the launches."""
    import torch

    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.train.optimizer import build_optimizer
    from hicom_tpu_torch.train.train_step import batch_to_device, create_train_state, make_loss_fn, make_train_step

    cfg = serving_config()
    model = build_model(cfg, device=DEVICE, seed=0)
    opt = build_optimizer(model, learning_rate=1e-3, guide_injector_lr=1e-3, total_steps=TRAIN_STEPS + 2,
                          tunable_parts="mm_projector", use_guide="direct")
    state = create_train_state(model, opt)
    params = dict(model.named_parameters())
    trained_before = {n: p.detach().clone() for n, p in params.items() if p.requires_grad}
    frozen_before = bit_sums((n, p) for n, p in params.items() if not p.requires_grad)
    batch = batch_to_device(multi_image_batch(cfg), torch.device(DEVICE), torch.bfloat16)
    step = make_train_step(modal="image", multi_image=True)
    reset_counts()
    times, metrics, fwd, bwd = run_steps(state, step, batch)
    V = model.visual_token_count(1, "image")
    launches = log_steps("multi-image", card, "HICom-7B stage 2 on 2 images a row", model, cfg, batch, times,
                         metrics, fwd, bwd, spliced=2 * (64 + 2 * (V - 1)),
                         inputs=f"2 images ({V} visual tokens each)")
    n_layers = cfg.text_config.num_hidden_layers
    if bwd != [n_layers + 1] * TRAIN_STEPS or launches["fused_tile_attention"]:
        raise AssertionError(f"[multi-image] flash backward per step {bwd} (not {n_layers + 1}: the decoder and the "
                             f"global compressor), or the tile kernel ran: {launches}")
    check_moved("multi-image", model, trained_before, frozen_before)
    train_profile("multi-image", state, step, batch, model.parameters(), lambda: state.optimizer.update(model),
                  loss_fn=make_loss_fn(model, "image", multi_image=True))
    del model, state, opt, params, trained_before, batch
    torch.cuda.empty_cache()
    return launches


def plain_vs_kernel_anyres_clip():
    """Phase 6c: the anyres and clip configurations at 2 decoder and 2 tower
    layers: last-token prefill logits and 8 greedy ids of one request
    (anyres: the 1920x1080 image through ``encode_anyres``; clip: the single
    video request), kernel path against plain path (decode included); and for
    the anyres configuration the projector's gradients of one train loss."""
    import torch

    from hicom_tpu_torch.api import HICom, build_model
    from hicom_tpu_torch.models.anyres import make_anyres_plan
    from hicom_tpu_torch.train.optimizer import build_optimizer
    from hicom_tpu_torch.train.train_step import batch_to_device, make_loss_fn

    for label, cfg in (("anyres", anyres_config(layers=2)), ("clip", clip_config(layers=2))):
        model = build_model(cfg, device=DEVICE, seed=6)
        hc = HICom(config=cfg, model=model, eos_token_id=cfg.text_config.eos_token_id, cache_len=4096)
        if label == "anyres":
            crops, size = anyres_images(cfg)[0]
            ids = anyres_prompt(WordTokenizer(cfg.text_config.vocab_size))

            def run():
                vis = hc.encode_anyres(crops, size)[None]
                with torch.inference_mode():
                    sp = model.embed_and_splice(torch.as_tensor(ids, device=DEVICE), vis)
                    logits = model.logits(model.model(sp.embeds, sp.positions)[:, -1]).float()
                return logits, hc.generate(ids, visual_embeds=vis, modal="image", max_new_tokens=8)
        else:
            _, single = make_requests(cfg, seed=3)

            def run():
                return last_logits(model, with_mask(single)), hc.generate(**single, max_new_tokens=8)

        got, got_ids = run()
        with plain_path():
            ref, ref_ids = run()
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        # bf16 activations round at other points on the two paths: 5% of the largest logit, as [slice]'s check
        log(f"[{label}] 2-layer last-token logits, kernel vs plain path: max_abs_err {err:.3g} (tol "
            f"{0.05 * scale:.3g}); greedy ids kernel {got_ids.tolist()} plain {ref_ids.tolist()}")
        if not (torch.isfinite(got).all() and scale > 0 and err <= 0.05 * scale) or not np.array_equal(got_ids,
                                                                                                     ref_ids):
            raise AssertionError(f"[{label}] the kernel path disagrees with the plain path")
        if label == "anyres":
            plan = make_anyres_plan(size, cfg, cfg.vision_config.image_size)
            build_optimizer(model, learning_rate=1e-3, tunable_parts="mm_projector").init(model)
            # one row: the plain path's autograd keeps each layer's fp32 scores over 7,333 tokens
            batch = batch_to_device({k: v[:1] for k, v in anyres_train_batch(cfg, plan, seed=7).items()},
                                    torch.device(DEVICE), torch.bfloat16)

            def grads():
                for p in model.parameters():
                    p.grad = None
                loss, _ = make_loss_fn(model, "image", anyres_plan=plan)(batch)
                loss.backward()
                return {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}

            got_g = grads()
            with plain_path():
                ref_g = grads()
            diff = sum((got_g[n] - ref_g[n]).square().sum() for n in ref_g).sqrt().item()
            norm = sum(g.square().sum() for g in ref_g.values()).sqrt().item()
            log(f"[anyres-train] 2-layer projector gradients, kernel vs plain path: {len(got_g)} tensors, global "
                f"|diff| / |plain| {diff / norm:.4g} (tol 0.05), |plain| {norm:.4g}")
            if set(got_g) != set(ref_g) or not (norm > 0 and diff <= 0.05 * norm):
                raise AssertionError("[anyres-train] kernel-path projector gradients disagree with the plain path")
        del model, hc
        torch.cuda.empty_cache()


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

    PHASE_START[0] = time.perf_counter()
    records = on_contract("kernels", kernel_checks(card))
    on_contract("quant-ops", quant_ops_checks(card))
    # each phase's launches by wrapper, counted from 0 just before it runs; after each phase, on_contract holds
    # its plain-route counts at 0 (every phase but [fp32-route] runs bf16 at K3's widths)
    launches = {"serve-engine": {}}
    # [serve-engine], then [seq-parallel], [mesh-serve] and [eval-dp], run on [slice]'s model before main_path frees it
    launches["serve"] = on_contract("slice", main_path(
        card, then=lambda hc: (launches["serve-engine"].update(serve_engine_phase(card, hc)),
                               launches.update(group_phases(card, hc)))))
    launches["clip"] = on_contract("clip", main_path(card, clip_config(), "clip"))
    launches["anyres"] = on_contract("anyres", anyres_phase(card))
    launches.update(on_contract("baseline-0.5b", baseline_05b_phase(card)))
    fp32_route_phase(card)  # the one phase whose decode steps K3's contract sends to the plain path
    phase_seconds("fp32-route")
    # fp32 HICom-7B; its decode steps' plain-route calls are checked and reset inside
    launches["fp32-serve"] = on_contract("fp32-serve", fp32_serve_phase(card))
    launches["fp32-train"] = on_contract("fp32-train", fp32_train_phase(card))
    # heads of 256; its decode steps' plain-route calls (layers x steps) are checked and reset inside
    launches["hd256"] = on_contract("hd256", hd256_phase(card))
    # heads of 512 in the decoder and of 288 in the tower, likewise
    launches["hd512"] = on_contract("hd512", hd512_phase(card))
    launches["serve-int8"] = on_contract("serve-int8", serve_quant_phase(card, "serve-int8", "int8"))
    launches["serve-w8a8"] = on_contract("serve-w8a8", serve_quant_phase(card, "serve-w8a8", "w8a8s", "w8a8s_mlp_qkv"))
    launches["model-init"] = on_contract("model-init", model_init_phase(card))
    launches["train"], train_record = on_contract("train", train_phase(card))
    launches["mesh-train"] = on_contract("mesh-train", mesh_train_phase(card, train_record))
    launches["stage3-lora"] = on_contract("stage3-lora", stage3_lora_phase(card))
    launches["stage3-qlora"] = on_contract("stage3-qlora", stage3_qlora_phase(card))
    launches["stage3-sft"], resident = on_contract("stage3-sft", stage3_sft_phase(card))
    launches["stage3-sft-offload"], _ = on_contract("stage3-sft-offload", stage3_sft_phase(card, resident=resident))
    del resident
    launches["anyres-train"] = on_contract("anyres-train", anyres_train_phase(card))
    launches["multi-image"] = on_contract("multi-image", multi_image_phase(card))
    on_contract("slice 2 layers", plain_vs_kernel_logits())
    on_contract("slice 2 layers", plain_vs_kernel_grads())
    on_contract("anyres/clip 2 layers", plain_vs_kernel_anyres_clip())
    on_contract("mesh-cli", mesh_cli_phase(card, on_contract("cli", cli_phase(card))))
    launches["closed-loop"] = on_contract("closed-loop", closed_loop_phase(card))
    on_contract("bench", bench_phase(card))
    # last: its 65 GB of pinned moments stay in PyTorch's host cache once freed
    launches["stage3-sft-7b-offload"] = on_contract("stage3-sft-7b-offload", stage3_sft_7b_offload_phase(card))

    kernels = []
    for name, (kid, phase, rec) in records.items():
        rec["launches"] = launches[phase].get(KERNELS[kid][0], 0)
        if rec["launches"] <= 0:
            raise AssertionError(f"{name}: [{phase}] never launched {KERNELS[kid][0]}")
        kernels.append(rec)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
