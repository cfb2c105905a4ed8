"""Unified eval inference entry point: one command per benchmark.

Port of ``hicom_tpu/eval/runner.py``: the model loads once (the port's
``model_init``) and the whole question set streams through ``mm_infer``, or
``mm_infer_batch`` with ``--batch-size`` above 1. ``--num-chunks/--chunk-idx``
remain for sharding over processes.

    python -m hicom_tpu_torch.eval.runner --benchmark videomme --model-path CKPT \\
        --video-folder ... --question-file ... --answer-file out.json [--device cpu]
    torchrun --nproc_per_node N -m hicom_tpu_torch.eval.runner --benchmark mvbench ... \\
        --data-parallel --batch-size 8

``--device`` defaults to ``cuda`` and raises without a card.
``--data-parallel`` splits each batch of ``mm_infer_batch`` over the ranks
(``HICom.shard_for_eval``). One process drives one device, so above one card
the ranks are ``torchrun``'s: the flag joins its process group (NCCL on the
card, gloo with ``--device cpu``); every rank runs the same loop, and only
rank 0 writes the answer files. Without ``torchrun`` it raises where more
than one card is visible, and one card is a mesh of one, as in JAX.
``--batch-size`` must divide the ranks (JAX's check and message).
``--scan-layers`` is accepted and has no numeric effect.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..api import _as_frames, mm_infer, model_init, resolve_device
from ..data.prompts import get_model_name_from_path
from .benchmarks import REGISTRY


def build_parser():
    p = argparse.ArgumentParser(description="hicom-tpu benchmark inference (PyTorch port)")
    p.add_argument("--benchmark", required=True, choices=sorted(REGISTRY))
    p.add_argument("--sub-benchmark", default=None, help="image_vqa variant: gqa/pope/vqav2/vizwiz/...")
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-base", default=None)
    p.add_argument("--video-folder", default=None)
    p.add_argument("--image-folder", default=None)
    p.add_argument("--subtitle-folder", default=None)
    p.add_argument("--question-file", required=True)
    p.add_argument("--answer-gt-file", default=None)
    p.add_argument("--answer-file", required=True)
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--load-8bit", action="store_true")
    p.add_argument("--load-4bit", action="store_true")
    p.add_argument("--tower-quant", default=None,
                   choices=("w8a8", "w8a8_mlp", "w8a8_mlp_qkv", "w8a8s", "w8a8s_mlp", "w8a8s_mlp_qkv"),
                   help="int8 serving tower (models/quant.py); static w8a8s* modes self-calibrate on the "
                        "first sample")
    p.add_argument("--dec-quant", default=None,
                   choices=("int8", "nf4", "w8a8", "w8a8_mlp", "w8a8s", "w8a8s_mlp"),
                   help="decoder quantization (int8/nf4 == --load-8bit/4bit; w8a8* runs the prefill's "
                        "linears in int8; w8a8s* uses static calibrated activation scales: pair with "
                        "--calib-video)")
    p.add_argument("--device-preprocess", action="store_true",
                   help="pad+resize+normalize video frames on the device (ops/preprocess.py): the host "
                        "only decodes")
    p.add_argument("--calib-video", default=None,
                   help="calibrate a static-quant tower or decoder (w8a8s*) on this video's frames before "
                        "eval, instead of the default self-calibration on the first eval sample")
    p.add_argument("--kv-cache-int8", action="store_true")
    p.add_argument("--scan-layers", action="store_true",
                   help="accepted and ignored: a compile-time layer layout of the JAX package with no "
                        "numeric effect")
    p.add_argument("--data-parallel", action="store_true",
                   help="split batched generation over the ranks of torchrun's process group (one device "
                        "each; only rank 0 writes the answers)")
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=1,
                   help="videos per batched generate (MCQA benchmarks)")
    p.add_argument("--skip-existing", action="store_true",
                   help="skip inference when the answer file already exists (reference guardrail)")
    p.add_argument("--device", default="cuda", help="the device to run on (the tests pass cpu)")
    return p


CALIB_QUESTION = "what is in the video ?"


def calibration_guide_ids(model):
    """The guide ids of the calibration question, encoded as ``mm_infer``
    encodes ``guide_instruct``; None for a model without the guide."""
    if not model.config.guide_enabled():
        return None
    if model.guide_tokenizer is None:
        raise ValueError("guide tokenizer unavailable: a guide-mode model calibrates with guide ids")
    return model.guide_tokenizer(CALIB_QUESTION, padding="max_length", truncation=True,
                                 max_length=model.config.guide_text_config.max_position_embeddings,
                                 return_tensors="np")["input_ids"]


def calibrate(model, processor, tokenizer, calib_video: str) -> None:
    """Static activation scales (``w8a8s*`` tower and decoder) from one clip
    that is not part of the benchmark: the tower's from its frames, the
    decoder's through a representative chat prompt over them; a guide-mode
    model's projector takes the question's guide ids."""
    import numpy as np

    quant = getattr(model.config.vision_config, "quantization", None) or ""
    dec_q = getattr(model.config.text_config, "quantization", None) or ""
    frames = _as_frames(processor["video"](calib_video))[None]
    guide_ids = calibration_guide_ids(model) if quant.startswith("w8a8s") or dec_q.startswith("w8a8s") else None
    if quant.startswith("w8a8s"):
        model.calibrate_tower(frames, guide_ids=guide_ids)
    if dec_q.startswith("w8a8s"):
        # the splice is dominated by visual tokens, so per-tensor amax is prompt-insensitive
        from ..constants import DEFAULT_VIDEO_TOKEN
        from ..data.prompts import tokenizer_multimodal_token

        msg = [{"role": "user", "content": DEFAULT_VIDEO_TOKEN + "\n" + CALIB_QUESTION}]
        prompt = tokenizer.apply_chat_template(msg, tokenize=False, add_generation_prompt=True)
        ids = np.asarray(tokenizer_multimodal_token(prompt, tokenizer, DEFAULT_VIDEO_TOKEN, return_tensors="np"))[None]
        model.calibrate_decoder(ids, frames, guide_ids=guide_ids)
    if not quant.startswith("w8a8s") and not dec_q.startswith("w8a8s"):
        print(f"--calib-video ignored: neither tower ({quant!r}) nor decoder ({dec_q!r}) has static activation "
              f"scales to calibrate", file=sys.stderr)


def data_parallel_device(device, batch_size: int):
    """``--data-parallel``: under ``torchrun``, join its process group and
    return this rank's device; without it, this process is the world, and
    more than one visible card raises. Exits with JAX's message when
    ``batch_size`` does not divide the ranks."""
    import torch

    from ..parallel.mesh import init_distributed, under_torchrun, world_size

    if under_torchrun():
        device = init_distributed(device)
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        raise SystemExit(f"--data-parallel over {torch.cuda.device_count()} cards runs one process per card: "
                         f"start the runner with `torchrun --nproc_per_node {torch.cuda.device_count()} -m "
                         f"hicom_tpu_torch.eval.runner ...`")
    n_dev = world_size()
    if batch_size % n_dev != 0:
        # batches only shard when the batch axis divides the device count
        raise SystemExit(
            f"--data-parallel needs --batch-size to be a multiple of the "
            f"{n_dev} devices (got {batch_size}); also note only the "
            f"batched MCQA benchmarks (mvbench/mlvu/...) shard — "
            f"batch-1 benchmarks run replicated."
        )
    return device


def main(argv=None):
    import torch.distributed as dist

    from ..utils import is_main_process

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.skip_existing and os.path.exists(args.answer_file) and os.path.getsize(args.answer_file) > 0:
        print(f"answer file exists, skipping: {args.answer_file}", file=sys.stderr)
        return
    joined = False  # whether this call joined torchrun's group (and so leaves it at the end)
    if args.data_parallel:
        joined = not dist.is_initialized()
        device = data_parallel_device(device, args.batch_size)
        joined = joined and dist.is_initialized()
    model, processor, tokenizer = model_init(
        args.model_path, model_base=args.model_base, dtype=args.dtype, device=device,
        load_8bit=args.load_8bit, load_4bit=args.load_4bit, load_w8a8_tower=args.tower_quant or False,
        dec_quant=args.dec_quant, device_preprocess=args.device_preprocess, kv_cache_int8=args.kv_cache_int8)
    if args.calib_video:
        calibrate(model, processor, tokenizer, args.calib_video)
    if args.data_parallel:
        model.shard_for_eval()
    args.model_id = get_model_name_from_path(args.model_path)

    def infer(tensor, instruct, modal="video", image_size=None, guide_instruct=None):
        kwargs = {}
        if model.config.guide_enabled() and guide_instruct is not None:
            kwargs["guide_instruct"] = guide_instruct
        return mm_infer(tensor, instruct, model, tokenizer, modal=modal, image_size=image_size, do_sample=False,
                        max_new_tokens=args.max_new_tokens, **kwargs)

    if args.batch_size > 1:
        from ..api import mm_infer_batch

        def infer_batch(tensors, instructs, guide_instructs):
            return mm_infer_batch(tensors, instructs, model, tokenizer, modal="video",
                                  guide_instructs=guide_instructs if model.config.guide_enabled() else None,
                                  max_new_tokens=args.max_new_tokens)

        args.infer_batch = infer_batch

    bench = REGISTRY[args.benchmark]()
    bench.run(args, processor, infer)
    if is_main_process():
        print(f"done: {args.benchmark} → {args.answer_file}", file=sys.stderr)
    if joined:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
