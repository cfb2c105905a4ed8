"""Training entry point: the reference's 3-stage recipe on one CUDA device.

Port of ``hicom_tpu/train/cli.py`` with the same flags (stages are selected by
flags alone, as in ``scripts/train_3stage_qwen25_7b.sh``) plus ``--device``:

  stage 1 (pretrain):      --is-pretraining --mm-tunable-parts mm_projector --learning-rate 1e-3
  stage 2 (cond-pretrain): --use-guide direct --pretrain-weights stage1/mm_projector.bin \\
                           --mm-tunable-parts mm_projector --guide-injector-lr 1e-3
  stage 3 (SFT):           --mm-tunable-parts mm_projector,language_model,vision_model_head,guide_encoder
                           (or --lora-enable: decoder adapters only)

    python -m hicom_tpu_torch.train.cli --model-path LLM --vision-tower TOWER \\
        --data-path data.json --output-dir out [stage flags]

``main`` parses, reads the tokenizers with ``transformers`` and calls
:func:`run`, which a caller without ``transformers`` may call with its own
tokenizer objects. Outputs, in ``--output-dir``: ``metrics.jsonl`` rows as the
JAX CLI writes them, ``checkpoints/<step>.pt`` every ``--save-steps``, and the
stage's export beside a ``config.json`` that ``load_model`` reads with
``model_base``: ``mm_projector.bin`` for projector-only stages, the peft
adapter and ``non_lora_trainables.bin`` (the projector) for ``--lora-enable``,
``hf_export/`` (an SFT checkpoint) otherwise.

``--bits 4`` / ``--bits 8`` with ``--lora-enable`` is QLoRA: the model is
built with NF4 / int8 linears for the decoder's seven linears of every layer
(``models/quant.py``), the base LLM's float weights are quantized as they are
loaded, one linear at a time on the device, and LoRA trains on that frozen
base, its side path in the compute dtype.

One device runs it all: ``--dp``, ``--fsdp`` or ``--tp`` above 1 and
``--offload-optimizer`` exit with the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import weights as W

SCAN_LAYERS_HELP = ("accepted and ignored: a compile-time layer layout of the JAX package "
                    "(lax.scan over stacked layers) with no numeric effect")


def build_parser():
    p = argparse.ArgumentParser(description="hicom-tpu trainer (PyTorch port)")
    # model
    p.add_argument("--model-path", required=True, help="base LLM / SFT checkpoint dir")
    p.add_argument("--vision-tower", default="google/siglip-so400m-patch14-384")
    p.add_argument("--mm-projector-type", default="local43_global32")
    p.add_argument("--use-guide", default=None)
    p.add_argument("--use-clip-scale", default="")
    p.add_argument("--mm-vision-select-layer", type=int, default=-2)
    p.add_argument("--mm-tunable-parts", default="mm_projector")
    p.add_argument("--pretrain-weights", default=None, help="stage-1 mm_projector.bin")
    p.add_argument("--image-aspect-ratio", default="pad")
    p.add_argument("--image-grid-pinpoints", default=None)
    p.add_argument("--mm-patch-merge-type", default="flat")
    p.add_argument("--mm-newline-position", default="one_token")
    p.add_argument("--num-frames", type=int, default=8)
    p.add_argument("--max-num-frames", type=int, default=256)
    p.add_argument("--model-max-length", type=int, default=4096)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--scan-layers", action="store_true", help=SCAN_LAYERS_HELP)
    p.add_argument("--remat", action="store_true",
                   help="checkpoint each decoder and vision-tower layer (activation memory)")
    # data
    p.add_argument("--data-path", nargs="+", required=True)
    p.add_argument("--data-folder", default=None)
    p.add_argument("--is-pretraining", action="store_true")
    # optimization
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--mm-projector-lr", type=float, default=None)
    p.add_argument("--vision-tower-lr", type=float, default=None)
    p.add_argument("--guide-injector-lr", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--lr-scheduler-type", default="cosine")
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--num-train-epochs", type=float, default=1.0)
    p.add_argument("--per-device-train-batch-size", type=int, default=1)
    p.add_argument("--gradient-accumulation-steps", type=int, default=1)
    p.add_argument("--group-by-modality-length", action="store_true", default=True)
    # parallelism (one device: values above 1 exit)
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    # lora
    p.add_argument("--lora-enable", action="store_true")
    p.add_argument("--lora-r", type=int, default=128)
    p.add_argument("--lora-alpha", type=int, default=256)
    p.add_argument("--offload-optimizer", action="store_true", help="not ported (exits)")
    p.add_argument("--bits", type=int, default=16, choices=(4, 8, 16),
                   help="QLoRA: store the frozen decoder base in NF4 (4) or int8 (8); requires --lora-enable")
    # io
    p.add_argument("--output-dir", required=True)
    p.add_argument("--save-steps", type=int, default=500)
    p.add_argument("--logging-steps", type=int, default=10)
    p.add_argument("--resume", action="store_true", default=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="the device to train on (the tests pass cpu)")
    return p


def check_supported(args) -> None:
    """Exit on a flag the port cannot honour yet, naming the ROADMAP item."""
    if max(args.dp or 1, args.fsdp, args.tp) > 1:
        raise SystemExit("--dp/--fsdp/--tp above 1 need the multi-GPU port (ROADMAP Queue 1 item 6)")
    if args.bits != 16 and not args.lora_enable:
        raise SystemExit("--bits 4/8 is QLoRA (frozen quantized base + LoRA adapters); pass --lora-enable")
    if args.offload_optimizer:
        raise SystemExit("--offload-optimizer is not ported (ROADMAP Queue 1 item 9)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_supported(args)
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.unk_token or tokenizer.eos_token
    guide_tokenizer = None
    if args.use_guide not in (None, "off"):
        guide_tokenizer = AutoTokenizer.from_pretrained(args.vision_tower)
    run(args, tokenizer, guide_tokenizer)


def build_config(args):
    """The model config from ``--model-path``'s config.json and the flags."""
    import dataclasses

    from ..config import HIComConfig, projector_qk_dim, tower_configs

    with open(os.path.join(args.model_path, "config.json")) as f:
        base_cfg = json.load(f)
    base_cfg.setdefault("model_type", "hicom_qwen2" if "qwen" in args.model_path.lower()
                        else base_cfg.get("model_type", "hicom_qwen2"))
    if not base_cfg["model_type"].startswith("hicom_"):
        base_cfg["model_type"] = "hicom_qwen2" if "qwen2" in base_cfg["model_type"] else "hicom_llama"
    cfg = HIComConfig.from_hf_dict(base_cfg)
    vision_cfg, guide_cfg = tower_configs(args.vision_tower)
    if args.remat:
        cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, remat=True))
        vision_cfg = dataclasses.replace(vision_cfg, remat=True)
    return cfg.replace(
        vision_config=vision_cfg,
        guide_text_config=guide_cfg,
        mm_vision_tower=args.vision_tower,
        mm_projector_type=args.mm_projector_type,
        mm_vision_select_layer=args.mm_vision_select_layer,
        mm_patch_merge_type=args.mm_patch_merge_type,
        mm_newline_position=args.mm_newline_position,
        image_aspect_ratio=args.image_aspect_ratio,
        image_grid_pinpoints=args.image_grid_pinpoints,
        use_guide=args.use_guide,
        use_clip_scale=args.use_clip_scale,
        num_frames=args.num_frames,
        max_num_frames=args.max_num_frames,
        model_max_length=args.model_max_length,
        dtype=args.dtype,
        projector_qk_dim=projector_qk_dim(vision_cfg),
    )


def pretrained_state(args, cfg) -> dict:
    """The weights the flags name, under the port's names: the base LLM from
    ``--model-path``, the towers from ``--vision-tower`` when it is a
    directory, the projector from ``--pretrain-weights``."""
    sd = {k: v for k, v in W.decoder_state(W.load_hf_state_dict(args.model_path)).items()
          if not (k == "lm_head.weight" and cfg.text_config.tie_word_embeddings)}
    if os.path.isdir(args.vision_tower):
        sd.update(W.tower_state(W.load_hf_state_dict(args.vision_tower), guide=cfg.guide_enabled()))
    if args.pretrain_weights:
        sd.update(W.convert_projector_state(W.load_torch_bin(args.pretrain_weights), cfg.projector.kind))
    return sd


def init_model(cfg, device, seed: int):
    """The model on ``device`` with PyTorch's default initialisation from
    ``seed`` (the parameters no checkpoint fills keep it)."""
    from ..models.hicom import HIComModel

    torch.manual_seed(seed)
    with torch.device(device):
        return HIComModel(cfg)


def run(args, tokenizer, guide_tokenizer=None):
    """Train as the flags say, with the given tokenizers (``guide_tokenizer``
    when ``--use-guide`` is on); returns the final state on its device: a
    ``TrainState`` (the model and the optimizer's fp32 masters), or with
    ``--lora-enable`` a ``LoraState`` (the frozen base with the adapters
    attached)."""
    from ..api import resolve_device
    from ..data.processor import SiglipImagePreprocessor
    from .checkpoints import export_mm_projector_bin, restore_checkpoint, save_checkpoint
    from .dataset import Collator, DataArguments, SupervisedDataset, iter_batches
    from .optimizer import build_optimizer, trainable_param_count

    check_supported(args)
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    cfg = build_config(args)

    image_processor = SiglipImagePreprocessor(size=(cfg.vision_config.image_size,) * 2)
    dargs = DataArguments(
        data_path=args.data_path,
        data_folder=args.data_folder,
        image_aspect_ratio=args.image_aspect_ratio,
        image_grid_pinpoints=args.image_grid_pinpoints,
        num_frames=args.num_frames,
        use_guide=args.use_guide,
        is_pretraining=args.is_pretraining,
        image_size=cfg.vision_config.image_size,
        patch_size=cfg.vision_config.patch_size,
        mm_patch_merge_type=args.mm_patch_merge_type,
        model_max_length=args.model_max_length,
    )
    dataset = SupervisedDataset(tokenizer, dargs, image_processor)
    collator = Collator(tokenizer, dargs, guide_tokenizer)
    batch_size = args.per_device_train_batch_size
    accum = args.gradient_accumulation_steps
    total_steps = int(max(1, len(dataset) // (batch_size * accum)) * args.num_train_epochs)
    modal = dataset.modality_of(0)

    state_dict = pretrained_state(args, cfg)
    model_cfg = cfg
    if args.bits != 16:
        # QLoRA: the float decoder never reaches the device whole; each linear
        # is quantized there once and the base keeps its codes
        import dataclasses

        from ..models.quant import quantize_decoder_params

        qmode = "nf4" if args.bits == 4 else "int8"
        state_dict = quantize_decoder_params(state_dict, qmode, device)
        model_cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, quantization=qmode))
    model = init_model(model_cfg, device, args.seed)
    W.load_into(model, state_dict)
    del state_dict
    with open(os.path.join(args.output_dir, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f, indent=2)

    def batches(step):
        return iter_batches(dataset, collator, batch_size, seed=args.seed + step,
                            group_by_modality=args.group_by_modality_length)

    def step_key(batch):
        # one step per (modal, multi_image, has_frames, anyres plan), as the JAX CLI keys its compiled steps
        return (batch.get("modal", modal), bool(batch.get("multi_image", False)), "frames" in batch,
                batch.get("anyres_plan"))

    def tensors(batch):
        return {k: v for k, v in batch.items() if not isinstance(v, (str, bool)) and k != "anyres_plan"}

    def log_row(row):
        with open(os.path.join(args.output_dir, "metrics.jsonl"), "a") as mf:
            mf.write(json.dumps(row) + "\n")

    if args.lora_enable:
        # LoRA: decoder adapters are the only trainable tensors; the base stays
        # frozen (the reference's peft wrap, train.py:619-635)
        from .lora import export_peft_adapter, init_lora_params
        from .train_step import create_lora_state, make_lora_train_step

        gen = torch.Generator(device).manual_seed(args.seed)
        lora = init_lora_params(model, rank=args.lora_r, generator=gen)
        state = create_lora_state(model, lora, alpha=args.lora_alpha, rank=args.lora_r,
                                  learning_rate=args.learning_rate, total_steps=total_steps,
                                  warmup_ratio=args.warmup_ratio, schedule_kind=args.lr_scheduler_type,
                                  weight_decay=args.weight_decay, device=device)
        print(f"total steps: {total_steps} | batch {batch_size} | {'Q' if args.bits != 16 else ''}LoRA r "
              f"{args.lora_r} alpha {args.lora_alpha}: {sum(p.numel() for p in state.lora.parameters()) / 1e6:.1f}M "
              f"adapter params | modal: {modal}")
        lora_steps: dict = {}
        step = 0
        while step < total_steps:
            advanced = False
            for batch in batches(step):
                advanced = True
                key = step_key(batch)
                if key not in lora_steps:
                    lora_steps[key] = make_lora_train_step(modal=key[0], has_frames=key[2], multi_image=key[1],
                                                          anyres_plan=key[3])
                state, metrics = lora_steps[key](state, tensors(batch))
                step += 1
                if step % args.logging_steps == 0:
                    loss = float(metrics["loss"])
                    print(f"[lora] step {step}/{total_steps} loss {loss:.4f}")
                    log_row({"step": step, "loss": loss, "time": time.time()})
                if step >= total_steps:
                    break
            if not advanced:
                raise RuntimeError("no full batches; reduce batch size")
        export_peft_adapter(state.lora.adapters(), args.output_dir, alpha=args.lora_alpha, rank=args.lora_r)
        # the reference LoRA layout carries the weights neither the base LLM
        # nor the tower holds (the projector) in non_lora_trainables.bin
        torch.save({f"base_model.model.{k}": v.detach().cpu() for k, v in model.state_dict().items()
                    if k.startswith(("model.mm_projector.", "model.image_newline"))},
                   os.path.join(args.output_dir, "non_lora_trainables.bin"))
        print(f"exported LoRA adapter to {args.output_dir}")
        return state

    from .train_step import create_train_state, make_train_step

    optimizer = build_optimizer(
        model,
        learning_rate=args.learning_rate,
        total_steps=total_steps,
        warmup_ratio=args.warmup_ratio,
        weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        mm_projector_lr=args.mm_projector_lr,
        vision_tower_lr=args.vision_tower_lr,
        guide_injector_lr=args.guide_injector_lr,
        tunable_parts=args.mm_tunable_parts,
        use_guide=args.use_guide,
        schedule_kind=args.lr_scheduler_type,
        gradient_accumulation_steps=accum,
    )
    state = create_train_state(model, optimizer, device)
    n_trainable = trainable_param_count(model, args.mm_tunable_parts, args.use_guide)
    print(f"total steps: {total_steps} | batch {batch_size} x accum {accum} "
          f"| trainable params: {n_trainable / 1e6:.1f}M | modal: {modal}")
    if args.resume and restore_checkpoint(args.output_dir, state) is not None:
        print(f"resumed from step {state.step}")

    step_fns: dict = {}
    t0 = time.time()
    step = state.step
    losses = []
    while step < total_steps * accum:
        made_progress = False
        for batch in batches(step):
            made_progress = True
            key = step_key(batch)
            if key not in step_fns:
                step_fns[key] = make_train_step(modal=key[0], has_frames=key[2], multi_image=key[1],
                                                anyres_plan=key[3])
            state, metrics = step_fns[key](state, tensors(batch))
            step += 1
            losses.append(metrics["loss"])
            if step % args.logging_steps == 0:
                loss = float(torch.stack(losses).mean())
                losses.clear()
                rate = step / max(time.time() - t0, 1e-9)
                print(f"step {step}/{total_steps} loss {loss:.4f} ({rate:.2f} it/s)")
                log_row({"step": step, "loss": loss, "it_per_s": rate, "time": time.time()})
            if step % args.save_steps == 0:
                save_checkpoint(args.output_dir, state, step)
            if step >= total_steps * accum:
                break
        if not made_progress:
            raise RuntimeError(f"dataset ({len(dataset)} samples) yields no full batches of size {batch_size}; "
                               "reduce batch size")

    save_checkpoint(args.output_dir, state, step)
    params = state.params()
    if set(args.mm_tunable_parts.split(",")) <= {"mm_projector", "attn_scale"}:
        # projector-only stages export the reference's mm_projector.bin
        export_mm_projector_bin(params, os.path.join(args.output_dir, "mm_projector.bin"))
        print(f"exported projector-only weights to {args.output_dir}/mm_projector.bin")
    else:
        # full SFT: reference-layout HF checkpoint (+ tokenizer files)
        export_dir = os.path.join(args.output_dir, "hf_export")
        W.export_hf_checkpoint(params, cfg, export_dir)
        if hasattr(tokenizer, "save_pretrained"):
            tokenizer.save_pretrained(export_dir)
        print(f"exported SFT checkpoint to {export_dir}")
    print("training done")
    return state


if __name__ == "__main__":
    main()
