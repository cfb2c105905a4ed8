"""Closed-loop accuracy self-test: train → export → reload → eval → score.

Port of ``hicom_tpu/selftest.py``. One command proves the full artifact chain
the reference exercises across separate scripts (3-stage recipe
``scripts/qwen2.5_7B/release/directg_local43_global32.sh:36-211`` feeding
``scripts/eval/video/eval_video_mcqa_videomme.sh:14-79``): the port's trainer
CLI produces a stage-1 ``mm_projector.bin`` and a stage-2 HF-layout SFT
export, ``model_init`` reloads that export from disk, the port's Video-MME
runner drives real mp4 decode + MCQA prompting through ``mm_infer``, and the
reference-parity scorer emits accuracy.

Everything is synthetic and tiny by default (2-layer towers/decoder,
word-level tokenizer, generated mp4s) so it runs offline on the CPU in a
minute (``--device cpu``). The SFT data teaches a constant answer ("B"); the
mini Video-MME ground truth is all "B", so a successful train→eval loop scores
well above the 25% MCQA chance floor: a check that the chain works, not a
benchmark accuracy.

The JAX loop trains at a global batch of 8 over 8 devices (``--dp 8``, batch
1 each); the port trains on one device at ``--per-device-train-batch-size 8``.
``run`` also takes the device, dtype, learning rate, logging interval and
base-model directories (``assets``), so that a caller can run the same loop
at another width (``chip_smoke.py``'s ``[closed-loop]``: HICom-7B widths).

Run: python -m hicom_tpu_torch.selftest [--workdir DIR] [--epochs N] [--device cpu]
Prints one JSON line: {"videomme_accuracy": ..., "chance": 25.0, ...}
"""

from __future__ import annotations

import argparse
import json
import os
import sys


VIS = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, image_size=56, patch_size=14)
TXT = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, vocab_size=99, max_position_embeddings=16,
           projection_size=64)
QWEN = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rope_theta=10000.0,
            tie_word_embeddings=False)

WORDS = [
    "describe", "the", "picture", "video", "a", "red", "cat", "dog", "number",
    "<image>", "<video>", "what", "is", "in", "color", "how", "many", "?",
    "A", "B", "C", "D", ".", ":", ",", "(", ")", "USER", "ASSISTANT",
    "Select", "best", "answer", "to", "following", "multiple-choice",
    "question", "based", "on", "Respond", "with", "only", "letter", "of",
    "correct", "option", "Answer", "option's", "from", "given", "choices",
    "directly", "and", "give", "The",
]


def _write_wordlevel_tokenizer(dirpath, words, chat_template=True, vocab_size=None):
    """A WordLevel tokenizer over ``words`` (ids 3 on; 0-2 are ``<unk>``,
    ``<pad>``, ``</s>``). With ``vocab_size`` the vocabulary is padded with
    filler words ``x<id>`` to that many ids, so that every id a model of that
    width can emit decodes (the fillers hold no capital letter, so no answer
    extractor reads an option letter in one)."""
    from tokenizers import Tokenizer, models as tok_models, pre_tokenizers

    vocab = {"<unk>": 0, "<pad>": 1, "</s>": 2}
    for w in words:
        if w not in vocab:
            vocab[w] = len(vocab)
    for i in range(len(vocab), vocab_size or 0):
        vocab[f"x{i}"] = i
    tk = Tokenizer(tok_models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.save(os.path.join(dirpath, "tokenizer.json"))
    cfg = {"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>",
           "pad_token": "<pad>", "eos_token": "</s>"}
    if chat_template:
        # vicuna-style: the assistant prefix must appear in BOTH the
        # add_generation_prompt rendering and the full-turn rendering, or
        # preprocess_chat's instruction-length masking swallows the answer
        # tokens (everything becomes IGNORE and loss is identically 0)
        cfg["chat_template"] = (
            "{% for m in messages %}"
            "{% if m['role'] == 'user' %}USER: {{ m['content'] }}\n"
            "{% else %}ASSISTANT: {{ m['content'] }}\n{% endif %}"
            "{% endfor %}"
            "{% if add_generation_prompt %}ASSISTANT:{% endif %}"
        )
    with open(os.path.join(dirpath, "tokenizer_config.json"), "w") as f:
        json.dump(cfg, f)


def build_base_assets(root: str):
    """Tiny HF base LLM + SigLIP tower directories (the inputs the reference's
    stage-1 script downloads from the hub), written by ``transformers`` from
    ``torch.manual_seed(0)``: the same files the JAX package's loop writes."""
    import torch
    import transformers

    llm_dir = os.path.join(root, "qwen_tiny")
    tower_dir = os.path.join(root, "siglip_tiny")
    os.makedirs(llm_dir, exist_ok=True)
    torch.manual_seed(0)
    transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**QWEN)).save_pretrained(llm_dir)
    _write_wordlevel_tokenizer(llm_dir, WORDS)
    transformers.SiglipModel(
        transformers.SiglipConfig(vision_config=VIS, text_config=TXT)
    ).save_pretrained(tower_dir)
    return llm_dir, tower_dir


def _write_mp4(path: str, seed: int, frames: int = 12, size: int = 64):
    import cv2
    import numpy as np

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (size, size))
    assert vw.isOpened(), path
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        vw.write(rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
    vw.release()


def build_train_data(root: str, n_images: int = 8, n_videos: int = 4):
    """Image+video SFT mixture. Captions for stage 1; stage 2 additionally
    teaches the constant MCQA answer "B" so the eval loop has learnable
    signal."""
    import numpy as np
    from PIL import Image

    media = os.path.join(root, "media")
    os.makedirs(media, exist_ok=True)
    cap_rows, sft_rows = [], []
    for i in range(n_images):
        name = f"img{i}.png"
        Image.fromarray(
            np.random.default_rng(i).integers(0, 255, (30, 40, 3), dtype=np.uint8)
        ).save(os.path.join(media, name))
        cap_rows.append({"image": name, "conversations": [
            {"from": "human", "value": "<image> describe the picture"},
            {"from": "gpt", "value": f"a red cat number {i % 4}"},
        ]})
        sft_rows.append({"image": name, "conversations": [
            {"from": "human", "value": "<image> what color is the cat ? The best answer is:"},
            {"from": "gpt", "value": "B"},
        ]})
    for i in range(n_videos):
        name = f"vid{i}.mp4"
        _write_mp4(os.path.join(media, name), seed=100 + i)
        sft_rows.append({"video": name, "conversations": [
            {"from": "human", "value": "<video> what is in the video ? The best answer is:"},
            {"from": "gpt", "value": "B"},
        ]})
    cap_json = os.path.join(root, "pretrain.json")
    sft_json = os.path.join(root, "sft.json")
    with open(cap_json, "w") as f:
        json.dump(cap_rows, f)
    with open(sft_json, "w") as f:
        json.dump(sft_rows, f)
    return cap_json, sft_json, media


def build_mini_videomme(root: str, n_videos: int = 2, q_per_video: int = 2):
    """A miniature Video-MME shard: parquet questions (all ground truth "B"),
    real mp4s keyed by youtube id, one srt (exercises subtitle alignment)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    vids = os.path.join(root, "videos")
    subs = os.path.join(root, "subs")
    os.makedirs(vids, exist_ok=True)
    os.makedirs(subs, exist_ok=True)
    cols = {k: [] for k in ("video_id", "videoID", "url", "duration", "domain",
                            "sub_category", "question_id", "task_type",
                            "question", "options", "answer")}
    for v in range(n_videos):
        ytid = f"selftest{v:02d}"
        _write_mp4(os.path.join(vids, f"{ytid}.mp4"), seed=200 + v, frames=24)
        if v == 0:
            with open(os.path.join(subs, f"{ytid}.srt"), "w") as f:
                f.write("1\n00:00:00,000 --> 00:00:01,000\na red cat\n\n")
        for q in range(q_per_video):
            cols["video_id"].append(str(v + 1))
            cols["videoID"].append(ytid)
            cols["url"].append(f"https://www.youtube.com/watch?v={ytid}")
            cols["duration"].append("short")
            cols["domain"].append("Knowledge")
            cols["sub_category"].append("Law")
            cols["question_id"].append(f"{v + 1}-{q + 1}")
            cols["task_type"].append("Action Recognition")
            cols["question"].append("what color is the cat ?")
            cols["options"].append(["A. red.", "B. blue.", "C. green.", "D. pink."])
            cols["answer"].append("B")
    qf = os.path.join(root, "videomme.parquet")
    pq.write_table(pa.table(cols), qf)
    return qf, vids, subs


# Serving numerics modes swept by ``quant_sweep``: every quantization the
# serving stack can load, scored against the fp numerics on the same trained
# checkpoint. Keys: (runner argv, model_init kwargs). "serving_default" is
# bench.py's headline config (--tower-quant w8a8s_mlp_qkv --dec-quant w8a8).
QUANT_MODES = {
    "fp": ((), {}),
    "int8_weight_only": (("--load-8bit",), {"load_8bit": True}),
    "nf4": (("--load-4bit",), {"load_4bit": True}),
    "tower_w8a8_mlp_qkv": (("--tower-quant", "w8a8_mlp_qkv"),
                           {"load_w8a8_tower": "w8a8_mlp_qkv"}),
    "tower_w8a8s_mlp_qkv": (("--tower-quant", "w8a8s_mlp_qkv"),
                            {"load_w8a8_tower": "w8a8s_mlp_qkv"}),
    "dec_w8a8": (("--dec-quant", "w8a8"), {"dec_quant": "w8a8"}),
    "dec_w8a8s": (("--dec-quant", "w8a8s"), {"dec_quant": "w8a8s"}),
    "serving_default": (("--tower-quant", "w8a8s_mlp_qkv", "--dec-quant", "w8a8"),
                        {"load_w8a8_tower": "w8a8s_mlp_qkv", "dec_quant": "w8a8"}),
    # static calibrated scales on BOTH tower and decoder
    "serving_w8a8s_dec": (("--tower-quant", "w8a8s_mlp_qkv", "--dec-quant", "w8a8s"),
                          {"load_w8a8_tower": "w8a8s_mlp_qkv", "dec_quant": "w8a8s"}),
}
EVAL_INSTRUCT = "what is in the video ? The best answer is:"
BATCH = 8  # the JAX loop's global batch: --dp 8 (its test devices) at batch 1


def _greedy_tokens(hicom, tokenizer, processor, video_path: str, instruct: str,
                   max_new: int) -> list:
    """First ``max_new`` greedy tokens for one video prompt (token-level, so
    quant-vs-fp agreement is measurable below the string level)."""
    import numpy as np

    from .api import _as_frames
    from .constants import DEFAULT_VIDEO_TOKEN
    from .data.prompts import tokenizer_multimodal_token

    frames = _as_frames(processor["video"](video_path))
    message = [{"role": "user", "content": DEFAULT_VIDEO_TOKEN + "\n" + instruct}]
    prompt = tokenizer.apply_chat_template(message, tokenize=False,
                                           add_generation_prompt=True)
    ids = np.asarray(tokenizer_multimodal_token(
        prompt, tokenizer, DEFAULT_VIDEO_TOKEN, return_tensors="np"))[None]
    out = hicom.generate(ids, frames=frames[None], modal="video",
                         max_new_tokens=max_new, do_sample=False)
    return [int(t) for t in out[0]]


def _runner_argv(hf_export: str, qf: str, vids: str, subs: str, answer_file: str,
                 device: str, dtype: str) -> list:
    return ["--benchmark", "videomme", "--model-path", hf_export, "--question-file", qf,
            "--video-folder", vids, "--subtitle-folder", subs, "--answer-file", answer_file,
            "--dtype", dtype, "--max-new-tokens", "4", "--device", device]


def quant_sweep(workdir: str, hf_export: str, qf: str, vids: str, subs: str,
                max_new: int = 64, modes=None, device: str = "cuda",
                dtype: str = "float32") -> dict:
    """Re-score the mini Video-MME under every serving quantization mode and
    measure greedy-token agreement vs the fp numerics.

    Returns {mode: {"videomme_accuracy": float, "token_agreement": float,
    "act_smooth_max": float or None}}.

    Static-quant modes (w8a8s*) calibrate on a SEPARATE synthetic video
    (distinct seed from both the train media and the eval shard: scales must
    not be fit on the distribution they are scored on); the runner gets it
    via ``--calib-video`` and the agreement leg calibrates on the same clip
    (``runner.calibrate``) before decoding.
    """
    import torch

    from .api import model_init
    from .eval import scorers
    from .eval.common import merge_chunked_videomme
    from .eval.runner import calibrate
    from .eval.runner import main as runner_main

    modes = {k: QUANT_MODES[k] for k in (modes or QUANT_MODES)}
    prompts = [(os.path.join(vids, f), EVAL_INSTRUCT)
               for f in sorted(os.listdir(vids)) if f.endswith(".mp4")]
    calib_mp4 = os.path.join(workdir, "calib.mp4")
    _write_mp4(calib_mp4, seed=777, frames=16)  # disjoint from train/eval seeds

    results, ref_tokens = {}, None
    for mode, (argv, kwargs) in modes.items():
        static = any(str(a).startswith("w8a8s") for a in argv)
        answer_file = os.path.join(workdir, "eval_quant", f"preds_{mode}.json")
        runner_main(_runner_argv(hf_export, qf, vids, subs, answer_file, device, dtype)
                    + list(argv) + (["--calib-video", calib_mp4] if static else []))
        report = scorers.score_videomme(
            merge_chunked_videomme([answer_file]), ["short"], skip_missing=True)

        hicom, processor, tokenizer = model_init(hf_export, dtype=dtype, device=device, **kwargs)
        if static:
            calibrate(hicom, processor, tokenizer, calib_mp4)
        toks = [_greedy_tokens(hicom, tokenizer, processor, vp, q, max_new)
                for vp, q in prompts]
        if mode == "fp":
            ref_tokens = toks
            agree = 1.0
        else:
            eos = int(hicom.eos_token_id)

            def pad(seq):
                return (list(seq) + [eos] * max_new)[:max_new]

            matches = sum(a == b for r, t in zip(ref_tokens, toks)
                          for a, b in zip(pad(r), pad(t)))
            agree = matches / (len(prompts) * max_new)
        fold = 0.0
        if static:
            for name, v in hicom.model.state_dict().items():
                if "act_smooth" in name:
                    fold = max(fold, float(v.max()))
        results[mode] = {"videomme_accuracy": report["overall"],
                         "token_agreement": round(agree, 4),
                         # > 1.0 ⇔ the SmoothQuant outlier fold engaged at
                         # some calibrated site (fill_act_scales)
                         "act_smooth_max": round(fold, 3) if fold else None}
        del hicom
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return results


def _inject_outlier_export(hf_export: str, out_dir: str, factor: float = 60.0,
                           channels=(3, 17, 40), device: str = "cuda") -> str:
    """Copy a trained HF export with synthetic outlier channels injected into
    the vision tower's and the decoder's pre-linear norms (gains x``factor``
    on a few channels, the consuming linears' input columns /``factor``, so
    fp outputs are unchanged but for the norms' biases and rounding: the
    trained-transformer outlier shape). Exercises the SmoothQuant fold end to
    end through load → calibrate → serve on a real (tiny) trained model."""
    import re
    import shutil

    from .api import load_model
    from .weights import export_hf_checkpoint

    hc = load_model(hf_export, dtype="float32", device=device)
    sd = {k: v.detach().clone() for k, v in hc.model.state_dict().items()}
    ch = list(channels)
    # (layer prefix, its hot norms, the linears that read them)
    sites = (
        (r"model\.vision_tower\.vision_tower\.vision_model\.encoder\.layers\.\d+\.",
         {"layer_norm1": ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
          "layer_norm2": ("mlp.fc1",)}),
        (r"model\.layers\.\d+\.",
         {"input_layernorm": ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
          "post_attention_layernorm": ("mlp.gate_proj", "mlp.up_proj")}),
    )
    for pattern, norms in sites:
        prefixes = sorted({m.group(0) for k in sd for m in [re.match(pattern, k)] if m})
        for p in prefixes:
            for norm, linears in norms.items():
                sd[p + norm + ".weight"][ch] *= factor
                for lin in linears:
                    sd[p + lin + ".weight"][:, ch] /= factor

    export_hf_checkpoint(sd, hc.config, out_dir, dtype="float32")
    for f in os.listdir(hf_export):  # tokenizer + processor sidecars
        src = os.path.join(hf_export, f)
        dst = os.path.join(out_dir, f)
        if os.path.isfile(src) and not os.path.exists(dst):
            shutil.copy(src, dst)
    return out_dir


def _metrics(out_dir: str) -> list:
    path = os.path.join(out_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def run(workdir: str, epochs: float = 20.0, num_frames: int = 4,
        n_questions_videos: int = 2, quant_modes=None,
        outlier_sweep: bool = False, device: str = "cuda", dtype: str = "float32",
        learning_rate: float = 1e-3, logging_steps: int = 20, assets=None) -> dict:
    """The loop; ``assets`` (base LLM directory with its tokenizer, tower
    directory) replaces the tiny ``build_base_assets``. Besides the JAX
    package's keys, the result holds each stage's ``metrics.jsonl`` rows."""
    from .api import resolve_device
    from .eval import scorers
    from .eval.common import merge_chunked_videomme
    from .eval.runner import main as runner_main
    from .train.cli import main as train_main

    device = str(resolve_device(device))
    os.makedirs(workdir, exist_ok=True)
    llm_dir, tower_dir = assets or build_base_assets(workdir)
    cap_json, sft_json, media = build_train_data(workdir)

    common = [
        "--vision-tower", tower_dir,
        "--mm-projector-type", "local43_global32",
        "--data-folder", media,
        "--num-frames", str(num_frames),
        "--per-device-train-batch-size", str(BATCH),
        "--dtype", dtype,
        "--save-steps", "1000",
        "--logging-steps", str(logging_steps),
        "--warmup-ratio", "0",
        "--device", device,
    ]

    # stage 1: projector alignment pretrain (reference stage "pretrain")
    stage1 = os.path.join(workdir, "stage1")
    train_main([
        "--model-path", llm_dir,
        "--mm-tunable-parts", "mm_projector",
        "--is-pretraining",
        "--data-path", cap_json,
        "--learning-rate", str(learning_rate),
        "--num-train-epochs", "2",
        "--output-dir", stage1,
    ] + common)
    projector_bin = os.path.join(stage1, "mm_projector.bin")
    assert os.path.exists(projector_bin), "stage 1 must export mm_projector.bin"

    # stage 2: SFT from the stage-1 projector → HF-layout export
    stage2 = os.path.join(workdir, "stage2")
    train_main([
        "--model-path", llm_dir,
        "--mm-tunable-parts", "mm_projector,language_model",
        "--pretrain-weights", projector_bin,
        "--data-path", sft_json,
        "--learning-rate", str(learning_rate),
        "--num-train-epochs", str(epochs),
        "--output-dir", stage2,
    ] + common)
    hf_export = os.path.join(stage2, "hf_export")
    assert os.path.isdir(hf_export), "stage 2 must export an HF-layout checkpoint"

    # eval: reload the export from disk and drive mini Video-MME end to end
    qf, vids, subs = build_mini_videomme(workdir, n_videos=n_questions_videos)
    answer_file = os.path.join(workdir, "eval", "preds.json")
    runner_main(_runner_argv(hf_export, qf, vids, subs, answer_file, device, dtype))

    results = merge_chunked_videomme([answer_file])
    report = scorers.score_videomme(results, ["short"], skip_missing=True)
    overall = report["overall"]  # 0-100 accuracy over answered questions
    out = {
        "videomme_accuracy": overall,
        "chance": 25.0,
        "n_questions": sum(len(r["questions"]) for r in results),
        "artifacts": {"mm_projector_bin": projector_bin, "hf_export": hf_export,
                      "answer_file": answer_file},
        "report": report,
        "metrics": {"stage1": _metrics(stage1), "stage2": _metrics(stage2)},
    }
    if quant_modes:
        modes = None if quant_modes is True else quant_modes
        out["quant_sweep"] = quant_sweep(workdir, hf_export, qf, vids, subs,
                                         modes=modes, device=device, dtype=dtype)
    if outlier_sweep:
        # the SmoothQuant fold end to end on TRAINED weights: inject
        # compensated outlier channels into the export and re-run the static
        # serving modes; the fold must ENGAGE (act_smooth_max > 1) and still
        # meet the agreement bar. fp is re-scored on the injected copy (its
        # own reference).
        inj = _inject_outlier_export(hf_export, os.path.join(workdir, "hf_export_outlier"),
                                     device=device)
        out["outlier_sweep"] = quant_sweep(
            workdir, inj, qf, vids, subs,
            modes=["fp", "serving_default", "serving_w8a8s_dec"], device=device, dtype=dtype)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default=None, help="default: a fresh temp dir")
    p.add_argument("--epochs", type=float, default=20.0, help="stage-2 SFT epochs")
    p.add_argument("--num-frames", type=int, default=4)
    p.add_argument("--quant-sweep", action="store_true",
                   help="re-score the mini Video-MME under every serving "
                        "quantization mode + greedy-token agreement vs fp")
    p.add_argument("--outlier-sweep", action="store_true",
                   help="also re-run the static serving modes on an export "
                        "with injected (compensated) outlier channels so the "
                        "SmoothQuant fold engages end-to-end")
    p.add_argument("--device", default="cuda", help="the device to run on (cpu: the plain paths)")
    args = p.parse_args(argv)
    workdir = args.workdir
    if workdir is None:
        import tempfile

        workdir = tempfile.mkdtemp(prefix="hicom_selftest_")
    out = run(workdir, epochs=args.epochs, num_frames=args.num_frames,
              quant_modes=args.quant_sweep, outlier_sweep=args.outlier_sweep,
              device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
