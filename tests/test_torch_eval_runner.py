"""The port's eval runner against the JAX package's on one exported checkpoint.

A tiny JAX model (``tiny_test_config()`` with the direct guide) is written by
``hicom_tpu.weights.export_hf_checkpoint`` (fp32) beside word-level
tokenizers over the selftest's words (the option letters among them), with a
tower directory for the guide tokenizer. JAX's ``runner.main`` and the
port's ``runner.main(... --device cpu)`` then run the same question sets from
real mp4s: a mini Video-MME (parquet, batch 1, with and without subtitles),
an MVBench-layout shard at ``--batch-size 2`` (``mm_infer_batch``), and the
mini Video-MME again under a static-quant tower (``--tower-quant
w8a8s_mlp_qkv``) calibrated on a separate clip (``--calib-video``), on an
export without the guide. The answer files must be equal line for line.

On the guide-mode export, JAX's runner calibrates the tower without guide ids
and raises ``AttributeError``; the port's encodes the calibration question
with the guide tokenizer (ROADMAP Queue 3 item 2, repaired in the port only),
and its scales equal those of ``calibrate_tower`` given those ids.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models.hicom import HIComModel as JModel

pytest.importorskip("transformers")
pytest.importorskip("cv2")
pytest.importorskip("pyarrow")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    from hicom_tpu.weights import export_hf_checkpoint
    from hicom_tpu_torch.eval.benchmarks import MVBENCH_TASKS
    from hicom_tpu_torch.selftest import WORDS, _write_mp4, _write_wordlevel_tokenizer, build_mini_videomme

    root = tmp_path_factory.mktemp("runner")
    tower = root / "siglip-so400m-patch14-384"  # the name keys the tower geometry
    tower.mkdir()
    base = jcfg.tiny_test_config()
    vis, txt = base.vision_config, base.guide_text_config
    with open(tower / "config.json", "w") as f:
        json.dump({"model_type": "siglip",
                   "vision_config": {k: getattr(vis, k) for k in ("hidden_size", "intermediate_size",
                                                                  "num_hidden_layers", "num_attention_heads",
                                                                  "image_size", "patch_size")},
                   "text_config": {k: getattr(txt, k) for k in ("hidden_size", "intermediate_size",
                                                                "num_hidden_layers", "num_attention_heads",
                                                                "vocab_size", "max_position_embeddings",
                                                                "projection_size")}}, f)
    _write_wordlevel_tokenizer(str(tower), WORDS, chat_template=False)
    n_vocab = 3 + len(WORDS)
    ckpts = {}
    for name, guide in (("HICom_tiny_sft", "direct"), ("HICom_tiny_sft_noguide", None)):
        ckpt = root / name
        ckpt.mkdir()
        _write_wordlevel_tokenizer(str(ckpt), WORDS)
        cfg = base.replace(text_config=jcfg.Qwen2Config(**{**base.text_config.__dict__, "vocab_size": n_vocab}),
                           use_guide=guide, mm_vision_tower=str(tower), num_frames=4)
        rng = np.random.default_rng(5)
        ids = rng.integers(3, n_vocab, (1, 10))
        ids[0, 2] = -201
        params = JModel(config=cfg).init(
            jax.random.PRNGKey(5), jnp.asarray(ids), jnp.asarray(rng.standard_normal((1, 4, 3, 56, 56)), jnp.float32),
            guide_ids=jnp.asarray(rng.integers(1, 10, (1, 16))) if guide else None)["params"]
        export_hf_checkpoint(jax.device_get(params), cfg, str(ckpt), dtype="float32")
        ckpts[guide] = str(ckpt)

    qf, vids, subs = build_mini_videomme(str(root))
    # an MVBench shard: 4 questions over 2 clips of one task, every other task empty
    mv_q, mv_v = root / "mvbench_json", root / "mvbench_videos"
    mv_q.mkdir()
    for task, (json_file, folder, _, _) in MVBENCH_TASKS.items():
        (mv_v / folder).mkdir(parents=True, exist_ok=True)
        rows = []
        if task == "Action Antonym":
            for i in range(4):
                _write_mp4(str(mv_v / folder / f"clip{i % 2}.mp4"), seed=300 + i % 2, frames=16)
                rows.append({"video": f"clip{i % 2}.mp4", "question": "what color is the cat ?",
                             "candidates": ["red", "blue", "green"], "answer": "blue"})
        (mv_q / json_file).write_text(json.dumps(rows))
    calib = root / "calib.mp4"
    _write_mp4(str(calib), seed=777, frames=16)
    return dict(root=root, ckpt=ckpts["direct"], ckpt_noguide=ckpts[None], qf=qf, vids=vids, subs=subs,
                mv_q=str(mv_q), mv_v=str(mv_v), calib=str(calib))


def _answers(a, tag, bench, extra, ckpt="ckpt"):
    """Run JAX's runner and the port's; return both answer files' lines."""
    from hicom_tpu.eval import runner as jax_runner
    from hicom_tpu_torch.eval import runner

    lines = []
    for main, side in ((jax_runner.main, "jax"), (runner.main, "port")):
        answer = os.path.join(str(a["root"]), f"{tag}_{side}", "preds.json")
        argv = ["--benchmark", bench, "--model-path", a[ckpt], "--answer-file", answer, "--dtype", "float32",
                "--max-new-tokens", "4"] + extra
        main(argv + (["--device", "cpu"] if side == "port" else []))
        with open(answer) as f:
            lines.append(f.read().splitlines())
        sub = answer.replace(".json", "_sub.json")
        if os.path.exists(sub):
            with open(sub) as f:
                lines[-1] += f.read().splitlines()
    return lines


def test_videomme_answers_match_jax(assets):
    got_jax, got = _answers(assets, "videomme", "videomme", [
        "--question-file", assets["qf"], "--video-folder", assets["vids"], "--subtitle-folder", assets["subs"]])
    assert got == got_jax
    recs = [json.loads(line.rstrip(",")) for line in got]
    assert len(recs) == 4 and sum(len(r["questions"]) for r in recs) == 8
    assert all(q["response"] in "ABCD" for r in recs for q in r["questions"])


def test_mvbench_batched_answers_match_jax(assets, monkeypatch):
    from hicom_tpu_torch import api

    calls = []
    orig = api.mm_infer_batch

    def traced(tensors, *a, **kw):
        calls.append(len(tensors))
        return orig(tensors, *a, **kw)

    monkeypatch.setattr(api, "mm_infer_batch", traced)
    got_jax, got = _answers(assets, "mvbench", "mvbench", [
        "--question-file", assets["mv_q"], "--video-folder", assets["mv_v"], "--batch-size", "2"])
    assert got == got_jax and len(got) == 4
    assert calls == [2, 2]


def test_static_tower_with_calib_video_matches_jax(assets):
    got_jax, got = _answers(assets, "calib", "videomme", [
        "--question-file", assets["qf"], "--video-folder", assets["vids"], "--subtitle-folder", assets["subs"],
        "--tower-quant", "w8a8s_mlp_qkv", "--calib-video", assets["calib"]], ckpt="ckpt_noguide")
    assert got == got_jax and len(got) == 4


class _Calibrated(Exception):
    pass


def test_calib_video_on_a_guide_export_uses_its_guide_ids(assets, monkeypatch):
    from hicom_tpu.eval import runner as jax_runner
    from hicom_tpu_torch.api import model_init
    from hicom_tpu_torch.eval import runner

    argv = ["--benchmark", "videomme", "--model-path", assets["ckpt"], "--question-file", assets["qf"],
            "--video-folder", assets["vids"], "--answer-file", str(assets["root"] / "calib_guide" / "preds.json"),
            "--dtype", "float32", "--tower-quant", "w8a8s_mlp_qkv", "--calib-video", assets["calib"]]
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'shape'"):  # the projector's guide
        jax_runner.main(argv)

    calibrated = []
    orig = runner.calibrate

    def stop_after(model, *a):  # the benchmark itself is test_torch_eval_runner's
        orig(model, *a)
        calibrated.append(model)
        raise _Calibrated

    monkeypatch.setattr(runner, "calibrate", stop_after)
    with pytest.raises(_Calibrated):
        runner.main(argv + ["--device", "cpu"])
    got = calibrated[0]
    assert got.tower_calibrated and got.config.guide_enabled()

    model, processor, _ = model_init(assets["ckpt"], dtype="float32", device="cpu",
                                     load_w8a8_tower="w8a8s_mlp_qkv")
    ids = model.guide_tokenizer("what is in the video ?", padding="max_length", truncation=True,
                                max_length=model.config.guide_text_config.max_position_embeddings,
                                return_tensors="np")["input_ids"]
    frames = runner._as_frames(processor["video"](assets["calib"]))[None]
    model.calibrate_tower(frames, guide_ids=ids)
    want, have = model.model.state_dict(), got.model.state_dict()
    scales = [k for k in want if k.endswith("act_scale")]
    assert scales and all(torch.equal(have[k], want[k]) for k in want)
