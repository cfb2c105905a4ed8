"""Data-parallel eval: ``HICom.shard_for_eval`` and the runner's ``--data-parallel`` in gloo ranks.

A tiny guide-mode JAX model is exported (fp32) with the selftest's word-level
tokenizers, as ``tests/test_torch_eval_runner.py`` exports it, beside an
MVBench-layout shard of 8 questions over 2 mp4 clips.

* ``shard_for_eval()`` in 2 gloo ranks (``tests/torch_ranks.eval_dp_worker``):
  ``mm_infer_batch`` of 4 videos, greedy and sampled, runs 2 rows on each
  rank and returns the strings of the unsharded call in this process; a batch
  of 3, which does not divide, runs whole on each rank with the same result.
  Only rank 0's ``open_answer_file`` writes; a ``--batch-size`` that does not
  divide the 2 ranks exits with JAX's message.
* The runner under ``python -m torch.distributed.run --nproc_per_node 2 ...
  --data-parallel --batch-size 8 --device cpu`` writes the answer file of the
  port's one-process run and of JAX's runner with ``--data-parallel
  --batch-size 8`` on its 8 virtual devices.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from hicom_tpu import config as jcfg
from hicom_tpu.models.hicom import HIComModel as JModel

pytest.importorskip("transformers")
pytest.importorskip("cv2")

QUESTION = "what color is the cat ?"
WORLD = 2


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    from hicom_tpu.weights import export_hf_checkpoint
    from hicom_tpu_torch.eval.benchmarks import MVBENCH_TASKS
    from hicom_tpu_torch.selftest import WORDS, _write_mp4, _write_wordlevel_tokenizer

    root = tmp_path_factory.mktemp("eval_dp")
    tower, ckpt = root / "siglip-so400m-patch14-384", root / "HICom_tiny_sft"  # the name keys the tower geometry
    tower.mkdir()
    ckpt.mkdir()
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
    _write_wordlevel_tokenizer(str(ckpt), WORDS)
    n_vocab = 3 + len(WORDS)
    cfg = base.replace(text_config=jcfg.Qwen2Config(**{**base.text_config.__dict__, "vocab_size": n_vocab}),
                       use_guide="direct", mm_vision_tower=str(tower), num_frames=4)
    rng = np.random.default_rng(7)
    ids = rng.integers(3, n_vocab, (1, 10))
    ids[0, 2] = -201
    params = jax.jit(lambda r: JModel(config=cfg).init(r, jnp.asarray(ids), jnp.zeros((1, 4, 3, 56, 56)),
                                                       guide_ids=jnp.ones((1, 16), jnp.int32)))(
        jax.random.PRNGKey(7))["params"]
    export_hf_checkpoint(jax.device_get(params), cfg, str(ckpt), dtype="float32")

    mv_q, mv_v = root / "mvbench_json", root / "mvbench_videos"
    mv_q.mkdir()
    for task, (json_file, folder, _, _) in MVBENCH_TASKS.items():
        (mv_v / folder).mkdir(parents=True, exist_ok=True)
        rows = []
        if task == "Action Antonym":
            for i in range(8):
                _write_mp4(str(mv_v / folder / f"clip{i % 2}.mp4"), seed=400 + i % 2, frames=16)
                rows.append({"video": f"clip{i % 2}.mp4", "question": f"what color is the cat {'?' * (1 + i % 3)}",
                             "candidates": ["red", "dog", "cat"][i % 3:] + ["red", "dog", "cat"][:i % 3],
                             "answer": "dog"})
        (mv_q / json_file).write_text(json.dumps(rows))
    return dict(root=root, ckpt=str(ckpt), mv_q=str(mv_q), mv_v=str(mv_v))


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(17)
    videos = rng.standard_normal((4, 4, 3, 56, 56)).astype(np.float32)
    greedy, sampled = dict(max_new_tokens=6), dict(max_new_tokens=6, do_sample=True, temperature=0.7)
    return {"greedy": (videos, greedy), "sampled": (videos, sampled), "whole_greedy": (videos[:3], greedy),
            "whole_sampled": (videos[:3], sampled)}


@pytest.fixture(scope="module")
def guide_ids():
    return np.random.default_rng(117).integers(1, 10, (1, 16))


@pytest.fixture(scope="module")
def ranks(assets, cases, guide_ids):
    root = assets["root"]
    torch.save(dict(cases=cases, question=QUESTION, guide_ids=guide_ids, answer_dir=str(root / "answers")),
               root / "payload.pt")
    R.spawn(R.eval_dp_worker, WORLD, assets["ckpt"], str(root / "payload.pt"), str(root / "out"))
    return [R.load(root / f"out.{r}") for r in range(WORLD)]


@pytest.mark.parametrize("case", ["greedy", "sampled", "whole_greedy", "whole_sampled"])
def test_sharded_batch_equals_unsharded(assets, cases, guide_ids, ranks, case):
    from transformers import AutoTokenizer

    import hicom_tpu_torch
    from hicom_tpu_torch.api import mm_infer_batch

    hc = hicom_tpu_torch.load_model(assets["ckpt"], dtype="float32", cache_len=256, device="cpu")
    videos, kw = cases[case]
    want = mm_infer_batch(list(videos), [QUESTION] * len(videos), hc, AutoTokenizer.from_pretrained(assets["ckpt"]),
                          guide_ids=np.repeat(guide_ids, len(videos), 0), **kw)
    assert len(want) == len(videos) and any(want)
    for res in ranks:
        assert res["no_jax"]
        texts, rows = res[case]
        assert texts == want
        assert rows == [len(videos) // WORLD if len(videos) % WORLD == 0 else len(videos)]


def test_only_rank0_writes_and_indivisible_batch_exits(assets, ranks):
    answers = assets["root"] / "answers"
    assert sorted(os.listdir(answers)) == ["rank0"] and (answers / "rank0" / "preds.json").read_text() == "answers\n"
    for res in ranks:
        assert res["indivisible"] == ("--data-parallel needs --batch-size to be a multiple of the 2 devices (got 3); "
                                      "also note only the batched MCQA benchmarks (mvbench/mlvu/...) shard — "
                                      "batch-1 benchmarks run replicated.")


def test_sample_token_is_multinomial_and_splits_by_rows():
    """``sample_token`` draws ``torch.multinomial``'s sample (the same tokens
    from the same generator state), and rows drawn apart with the whole
    batch's noise are the whole batch's rows."""
    from hicom_tpu_torch.models.generate import sample_token

    logits = torch.randn(4, 512, generator=torch.Generator().manual_seed(2))
    got = sample_token(logits, torch.Generator().manual_seed(5), 0.7, 0.9)
    probs = torch.softmax(logits / 0.7, -1)
    kept = probs.sort(-1, descending=True).values
    cutoff = kept.gather(-1, (kept.cumsum(-1) < 0.9).sum(-1, keepdim=True))
    want = torch.multinomial(torch.softmax((logits / 0.7).masked_fill(probs < cutoff, float("-inf")), -1), 1,
                             generator=torch.Generator().manual_seed(5))[:, 0]
    assert torch.equal(got, want)
    for rows in (slice(0, 2), slice(2, 4)):
        assert torch.equal(sample_token(logits[rows], torch.Generator().manual_seed(5), 0.7, 0.9, (rows, 4)), got[rows])


@pytest.mark.parametrize("top_p", [0.9, 1.0])
def test_top_p_keeps_jax_tokens(top_p, monkeypatch):
    """The nucleus ``sample_token`` draws from is JAX's (the logits JAX's
    ``sample_token`` hands ``jax.random.categorical``), also where the
    cumulative probability never reaches ``top_p``: there the port's index
    ran past the vocabulary (a ``RuntimeError`` on the CPU, a device assert on the
    card), and JAX's take keeps every token."""
    from hicom_tpu.models import generate as jgen
    from hicom_tpu_torch.models.generate import top_p_logits

    logits = np.random.default_rng(1).standard_normal((4, 152064)).astype(np.float32)
    seen = {}
    monkeypatch.setattr(jax.random, "categorical", lambda key, lg, axis=-1: seen.setdefault("l", lg).argmax(axis))
    jgen.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0), 0.7, top_p)
    kept, jax_kept = torch.isfinite(top_p_logits(torch.from_numpy(logits), 0.7, top_p)), np.isfinite(seen["l"])
    if top_p < 1.0:
        assert np.array_equal(kept.numpy(), jax_kept)
    else:  # the rows the old index ran past (the two packages' fp32 sums round apart elsewhere)
        cum = torch.softmax(torch.from_numpy(logits / 0.7).sort(-1, descending=True).values, -1).cumsum(-1)
        past = ((cum < top_p).sum(-1) == logits.shape[-1]).numpy()
        assert past.sum() >= 2 and kept.numpy()[past].all() and jax_kept[past].all()


def test_runner_under_torchrun_equals_one_process_and_jax(assets, tmp_path):
    from hicom_tpu.eval import runner as jax_runner
    from hicom_tpu_torch.eval import runner

    def argv(answer):
        return ["--benchmark", "mvbench", "--model-path", assets["ckpt"], "--question-file", assets["mv_q"],
                "--video-folder", assets["mv_v"], "--answer-file", str(answer), "--dtype", "float32",
                "--max-new-tokens", "4", "--data-parallel", "--batch-size", "8"]

    ranked = tmp_path / "torchrun" / "preds.json"
    job = R.Torchrun(WORLD, argv(ranked) + ["--device", "cpu"], str(tmp_path / "torchrun.log"),
                     module="hicom_tpu_torch.eval.runner")
    try:
        runner.main(argv(tmp_path / "one" / "preds.json") + ["--device", "cpu"])
        jax_runner.main(argv(tmp_path / "jax" / "preds.json"))
        rc, log = job.wait()
    finally:
        job.stop()
    assert rc == 0, log[-3000:]
    got = ranked.read_text().splitlines()
    assert len(got) == 8
    assert got == (tmp_path / "one" / "preds.json").read_text().splitlines()
    assert got == (tmp_path / "jax" / "preds.json").read_text().splitlines()
    assert os.listdir(ranked.parent) == ["preds.json"]
