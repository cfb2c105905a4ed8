"""The port's eval harness and conversation templates against the JAX
package's, case for case with ``tests/test_eval.py``.

``hicom_tpu_torch/eval/{common, benchmarks, scorers, score, gpt_judge}.py``
and ``conversation.py`` are copies of the JAX package's modules. Each test
runs the JAX function and the port's on the same inputs and compares them
exactly: extracted letters, scores, parsed subtitles, guide prompts, the
MCQA batching, the prefetch order, the judge's prompts, cache and
aggregation (with a stubbed client), every benchmark's answer file byte for
byte from the same fake ``infer``, and every template's prompt. Where
``tests/test_eval.py`` also states the expected value, the port is held to it.
"""

import importlib
import json
import os

import numpy as np
import pytest


def both(module: str, name: str = None):
    """(JAX's, the port's) module ``module``, or its attribute ``name``."""
    mods = [importlib.import_module(f"{pkg}.{module}") for pkg in ("hicom_tpu", "hicom_tpu_torch")]
    return tuple(getattr(m, name) for m in mods) if name else tuple(mods)


def test_videomme_letter_extraction_matches_jax():
    jax_fn, fn = both("eval.scorers", "videomme_extract_letter")
    cases = [
        "A", "(B)", " C.", "The best answer is D", "Answer: B", "b",
        "I think the answer to this question about the video is definitely not known",
        "The correct answer is (A).", "blah blah C blah", "",
        "The best option isThe correct option is B", "one two three four five six seven eight nine ten eleven",
    ]
    for s in cases:
        assert fn(s) == jax_fn(s), s


def test_vqa_accuracy_matches_jax():
    (jax_proc, proc), (jax_ev, ev) = both("eval.scorers", "EvalAIAnswerProcessor"), \
        both("eval.scorers", "TextVQAAccuracyEvaluator")
    jax_st, st = both("eval.scorers", "STVQAAccuracyEvaluator")
    for ans in ["Two Dogs.", "a CAT", "isnt it", "one hundred", "3,000", "yes!", "don't know",
                "the three dogs", "it's 5 o'clock", "none", "COULDNT say; maybe", "10.5"]:
        assert proc()(ans) == jax_proc()(ans), ans
    rng = np.random.default_rng(0)
    words = ["cat", "dog", "two", "red", "yes", "no", "none", "a dog", "the cat"]
    preds = [{"pred_answer": words[rng.integers(len(words))],
              "gt_answers": [words[rng.integers(len(words))] for _ in range(10)]} for _ in range(25)]
    assert ev().eval_pred_list(preds) == jax_ev().eval_pred_list(preds)
    assert st().eval_pred_list(preds) == jax_st().eval_pred_list(preds)


MCQA_CASES = [
    ("(B)", ["A", "B", "C", "D"], ["red", "blue", "green", "7"], False, 1),
    ("The answer is D.", ["A", "B", "C", "D"], ["red", "blue", "green", "7"], False, 3),
    ("it looks blue to me", ["A", "B", "C", "D"], ["red", "blue", "green", "7"], False, 1),
    ("seven", ["A", "B", "C", "D"], ["red", "blue", "green", "7"], True, 3),
    ("no idea", ["A", "B", "C", "D"], ["red", "blue", "green", "7"], False, 2),
    ("A", ["A", "B", "C", "D", "E"], None, False, 0),
]


@pytest.mark.parametrize("output,letters,options,digit_words,want", MCQA_CASES)
def test_mcqa_letter_extraction(output, letters, options, digit_words, want):
    jax_fn, fn = both("eval.common", "extract_mcqa_letter")
    got = fn(output, letters, options, match_digit_words=digit_words)
    assert got == jax_fn(output, letters, options, match_digit_words=digit_words) == want


def test_chunking_and_videomme_merge_match_jax(tmp_path):
    (jax_chunk, chunk), (jax_merge, merge) = both("eval.common", "get_chunk"), \
        both("eval.common", "merge_chunked_videomme")
    for n in (1, 3, 4, 7):
        for i in range(n + 1):
            assert chunk(list(range(10)), n, i) == jax_chunk(list(range(10)), n, i)
    files = []
    for i in range(2):
        path = tmp_path / f"chunk{i}.json"
        path.write_text("".join(json.dumps({"video_id": f"{i}{j}"}) + ",\n" for j in range(2)))
        files.append(str(path))
    (tmp_path / "empty.json").write_text("")
    files.append(str(tmp_path / "empty.json"))
    assert merge(files) == jax_merge(files) and len(merge(files)) == 4


def test_videomme_scoring():
    jax_fn, fn = both("eval.scorers", "score_videomme")
    results = [
        {"duration": "short", "domain": "Knowledge", "sub_category": "Law", "missing": False,
         "questions": [{"task_type": "Action Recognition", "answer": "A", "response": "A"},
                       {"task_type": "Action Recognition", "answer": "B", "response": "C"}]},
        {"duration": "long", "domain": "Life Record", "sub_category": "Travel", "missing": True,
         "questions": [{"task_type": "OCR Problems", "answer": "A", "response": "A"}]},
    ]
    report = fn(results)
    assert report == jax_fn(results)
    assert report["short"]["overall"] == 50.0 and report["long"]["answered"] == 0 and report["overall"] == 50.0
    assert fn(results, skip_missing=False) == jax_fn(results, skip_missing=False)


@pytest.mark.parametrize("scorer", ["score_mvbench", "score_mlvu", "score_mcqa_jsonl"])
def test_mcqa_jsonl_scoring(tmp_path, scorer):
    jax_fn, fn = both("eval.scorers", scorer)
    path = tmp_path / "preds.jsonl"
    rows = [{"vid": "a", "task_type": "Action Count", "pred": 1, "gt": 1},
            {"vid": "b", "task_type": "Action Count", "pred": 0, "gt": 1},
            {"vid": "c", "task_type": "Moving Count", "pred": 2, "gt": 2},
            {"vid": "d", "task_type": "needle", "pred": 0, "gt": 0}]
    path.write_text("\n".join(json.dumps(r) for r in rows))
    report = fn(str(path))
    assert report == jax_fn(str(path))
    if scorer == "score_mvbench":
        assert report["by_task"]["Action Count"] == 50.0


def test_egoschema_scoring(tmp_path):
    jax_fn, fn = both("eval.scorers", "score_egoschema_csv")
    csv = tmp_path / "out.csv"
    csv.write_text("uid1, 4\nuid2, 0\nuid3, 2\n")
    answers = tmp_path / "answers.json"
    answers.write_text(json.dumps({"uid1": 4, "uid2": 1}))
    assert fn(str(csv), str(answers)) == jax_fn(str(csv), str(answers))
    assert fn(str(csv)) == jax_fn(str(csv))


def test_pope_scoring(tmp_path):
    jax_fn, fn = both("eval.scorers", "score_pope")
    labels = tmp_path / "labels.json"
    labels.write_text("\n".join(json.dumps({"label": label}) for label in ["yes", "no", "yes", "no"]))
    answers = [{"text": "Yes, there is."}, {"text": "No."}, {"text": "I do not think so, no"}, {"text": "yes"}]
    r = fn([dict(a) for a in answers], str(labels))
    assert r == jax_fn([dict(a) for a in answers], str(labels))
    assert r["TP"] == 1 and r["TN"] == 1 and r["FN"] == 1 and r["FP"] == 1 and r["accuracy"] == 0.5


def test_pope_all_scoring(tmp_path):
    jax_fn, fn = both("eval.scorers", "score_pope_all")
    ann = tmp_path / "ann"
    ann.mkdir()
    questions, results = [], []
    for c, cat in enumerate(("adversarial", "popular", "random")):
        labels = []
        for i in range(4):
            qid = c * 10 + i
            questions.append({"question_id": qid, "category": cat})
            results.append({"question_id": qid, "text": "yes" if (i + c) % 2 else "no"})
            labels.append(json.dumps({"question_id": qid, "label": "yes" if i % 2 else "no"}))
        (ann / f"coco_pope_{cat}.json").write_text("\n".join(labels))
    qf, rf = tmp_path / "q.jsonl", tmp_path / "r.jsonl"
    qf.write_text("\n".join(json.dumps(q) for q in questions))
    rf.write_text("\n".join(json.dumps(r) for r in results))
    assert fn(str(qf), str(rf), str(ann)) == jax_fn(str(qf), str(rf), str(ann))


def test_submission_converters_match_jax(tmp_path):
    rows = [{"question_id": i, "text": t} for i, t in enumerate(["Yes.", "two dogs", "", "Unanswerable"])]
    src = tmp_path / "res.jsonl"
    src.write_text("\n".join(json.dumps(r) for r in rows))
    split = tmp_path / "split.jsonl"
    split.write_text("\n".join(json.dumps({"question_id": i}) for i in range(6)))
    ann = tmp_path / "ann.json"
    ann.write_text("\n".join(json.dumps({"question_id": i, "image": f"img{i}.jpg"}) for i in range(4)))
    for name, extra in (("convert_gqa_for_eval", ()), ("convert_vqav2_for_submission", (str(split),)),
                        ("convert_vizwiz_for_submission", (str(ann),))):
        outs = []
        for fn, tag in zip(both("eval.scorers", name), ("jax", "port")):
            dst = tmp_path / f"{name}_{tag}.json"
            fn(str(src), *extra, str(dst))
            outs.append(dst.read_bytes())
        assert outs[0] == outs[1], name


def test_srt_parsing(tmp_path):
    jax_fn, fn = both("eval.benchmarks", "_load_srt")
    srt = tmp_path / "x.srt"
    srt.write_text("1\n00:00:01,000 --> 00:00:03,500\nHello there\n\n"
                   "2\n00:00:04,000 --> 00:00:06,000\n<i>Styled</i> text\\Nsecond line\n\n"
                   "3\nno time line\n\n4\n00:00:07,000 --> bad\nskipped\n")
    entries = fn(str(srt))
    assert entries == jax_fn(str(srt))
    assert entries[0] == (1000, 3500, "Hello there") and entries[1][2] == "Styled text second line"


GUIDE_CASES = [
    ("What color?\nAnswer the question using a single word or phrase.", "gqa", "What color?"),
    ("Which?\nA. cat\nB. dog", "scienceqa", "Which?"),
    ("Read this\nReference OCR token: abc", "textvqa", "Read this"),
    ("Is it?\nAnswer the question using a single word or phrase.", "pope", "Is it?"),
    ("Which?\nA. one\nB. two", "seed_bench", "Which?"),
    ("What?\nWhen the provided information is insufficient, respond with 'Unanswerable'.\n"
     "Answer the question using a single word or phrase.", "vizwiz", "What?"),
    ("Anything else?", "mmbench", "Anything else?"),
]


@pytest.mark.parametrize("question,bench,want", GUIDE_CASES)
def test_guide_instruct_rules(question, bench, want):
    jax_fn, fn = both("eval.benchmarks", "get_guide_instruct")
    assert fn(question, bench) == jax_fn(question, bench) == want


def _mcqa_trace(run_mcqa, batch_size, batched):
    items = [dict(idx=i, t=(2 if i < 3 else 4)) for i in range(5)]
    recorded, batch_sizes = [], []

    def prepare(item):
        tensor = np.zeros((item["t"], 3, 4, 4))
        return (tensor, f"q{item['idx']}", {"question": f"q{item['idx']}", "candidates": ["a", "b"]}, ["A", "B"],
                f"v{item['idx']}", 0, "task")

    def record(out, prep):
        recorded.append((prep[4], out))

    def infer_batch(tensors, instructs, guides):
        batch_sizes.append(len(tensors))
        return [f"out:{i}|{g}" for i, g in zip(instructs, guides)]

    def infer(t, q, modal, guide_instruct):
        return f"s:{q}|{modal}|{guide_instruct}"

    run_mcqa(items, prepare, record, infer, infer_batch if batched else None, batch_size)
    return recorded, batch_sizes


@pytest.mark.parametrize("batch_size,batched", [(2, True), (3, True), (1, False), (2, False)])
def test_run_mcqa_batching(batch_size, batched):
    jax_fn, fn = both("eval.benchmarks", "run_mcqa")
    got = _mcqa_trace(fn, batch_size, batched)
    assert got == _mcqa_trace(jax_fn, batch_size, batched)
    assert [r[0] for r in got[0]] == [f"v{i}" for i in range(5)]
    if (batch_size, batched) == (2, True):
        assert got[1] == [2, 2, 2] and got[0][0] == ("v0", "out:q0|q0")


def test_frame_sample_matches_jax():
    jax_fn, fn = both("data.video", "frame_sample")
    for duration in (1, 7, 8, 9, 31, 32, 100, 723):
        for nf in (1, 4, 8, 16, 32):
            np.testing.assert_array_equal(fn(duration, mode="uniform", num_frames=nf),
                                          jax_fn(duration, mode="uniform", num_frames=nf))
        for fps in (10, 24, 25, 30):
            np.testing.assert_array_equal(fn(duration, mode="fps", fps=fps), jax_fn(duration, mode="fps", fps=fps))


# --------------------------------------------------------------------------- #
# GPT judge (a stubbed client)
# --------------------------------------------------------------------------- #


class _FakeJudgeClient:
    """Stands in for AzureOpenAI: returns canned verdicts, records the
    messages and the completion parameters."""

    def __init__(self, replies):
        self.replies = list(replies)
        self.calls = []
        fake = self

        class _Completions:
            def create(self, model, messages, temperature, **kwargs):
                fake.calls.append((model, messages, temperature, kwargs))
                msg = type("Msg", (), {"content": fake.replies[len(fake.calls) - 1]})()
                choice = type("Choice", (), {"message": msg})()
                return type("Out", (), {"choices": [choice]})()

        self.chat = type("Chat", (), {"completions": _Completions()})()


AXES = ["correctness", "detailed_orientation", "context", "temporal", "consistency", "activitynet",
        "msvc_correctness", "msvc_detailedness"]


@pytest.mark.parametrize("axis", AXES)
def test_gpt_judge_rubrics_match_jax(axis):
    jax_judge, judge = both("eval.gpt_judge")
    assert judge.RUBRICS[axis] == jax_judge.RUBRICS[axis]
    qa = {k: "{%s}" % k for k in ("question", "answer", "pred", "question1", "question2", "pred1", "pred2")}
    assert judge.build_messages(axis, qa) == jax_judge.build_messages(axis, qa)
    real = {"Q": "what?", "Q1": "first", "Q2": "second", "A": "a cat", "pred": "a dog", "P1": "p1", "P2": "p2"}
    assert judge.build_messages(axis, real) == jax_judge.build_messages(axis, real)


def _judge_run(judge, monkeypatch, results, out_dir, replies):
    client = _FakeJudgeClient(replies)
    monkeypatch.setattr(judge, "_client", lambda: client)
    return judge.judge_results(str(results), str(out_dir), axis="correctness", num_workers=1), client


def test_gpt_judge_caching_and_aggregation(tmp_path, monkeypatch):
    rows = [{"question_id": "q1", "question": "what?", "answer": "a cat", "pred": "a cat"},
            {"question_id": "q2", "question": "who?", "answer": "a dog", "pred": "a fish"},
            {"question_id": "q3", "question": "when?", "answer": "noon", "pred": "noon"}]
    results = tmp_path / "preds.jsonl"
    results.write_text("\n".join(json.dumps(r) for r in rows))
    replies = ["{'pred': 'yes', 'score': 5}", "{'pred': 'no', 'score': 1}", "{'pred': 'yes', 'score': 4}"]
    out = {}
    for judge, tag in zip(both("eval.gpt_judge"), ("jax", "port")):
        report, client = _judge_run(judge, monkeypatch, results, tmp_path / tag, replies)
        cache = {f: (tmp_path / tag / f).read_bytes() for f in sorted(os.listdir(tmp_path / tag))}
        # resume: the cached files short-circuit the client
        report2, client2 = _judge_run(judge, monkeypatch, results, tmp_path / tag, [])
        assert report2 == report and client2.calls == []
        out[tag] = (report, client.calls, cache)
    assert out["port"] == out["jax"]
    report = out["port"][0]
    assert report["judged"] == 3 and report["accuracy"] == pytest.approx(2 / 3)
    assert report["mean_score"] == pytest.approx((5 + 1 + 4) / 3)


def test_gpt_judge_consistency_prompt():
    verdicts, calls = [], []
    qa = {"Q1": "first q", "Q2": "second q", "A": "gt", "P1": "pred one", "P2": "pred two"}
    for judge in both("eval.gpt_judge"):
        client = _FakeJudgeClient(["{'pred': 'yes', 'score': 3}"])
        verdicts.append(judge._judge_one(client, "m", "consistency", qa))
        calls.append(client.calls)
    assert verdicts[0] == verdicts[1] == {"pred": "yes", "score": 3}
    assert calls[0] == calls[1]
    for frag in ("first q", "second q", "gt", "pred one", "pred two"):
        assert frag in calls[1][0][1][1]["content"]


def test_gpt_judge_aggregate_skips_failed(tmp_path):
    d = tmp_path / "judged"
    d.mkdir()
    (d / "a.json").write_text(json.dumps([{"pred": "yes", "score": 4}, {"question_id": "a"}]))
    (d / "b.json").write_text(json.dumps([{"pred": "no", "score": "2"}, {"question_id": "b"}]))
    (d / "notes.txt").write_text("x")
    jax_fn, fn = both("eval.gpt_judge", "aggregate_judgments")
    assert fn(str(d)) == jax_fn(str(d))


# --------------------------------------------------------------------------- #
# Benchmark runners: the same fake infer through both packages' classes
# --------------------------------------------------------------------------- #


class _Args:
    def __init__(self, **kw):
        self.num_chunks = 1
        self.chunk_idx = 0
        self.answer_gt_file = None
        self.__dict__.update(kw)


def _fake_processor():
    return {"video": lambda path, **kw: f"tensor<{path}>"}


def run_both(tmp_path, cls, args_kw, processor, infer, answer_name="preds.jsonl", extra_files=()):
    """Run benchmark class ``cls`` of each package with the same inputs into
    its own answer file; return (the port's answer texts, JAX's, the port's
    infer calls, JAX's)."""
    texts, calls = {}, {}
    for bench, tag in zip(both("eval.benchmarks", cls), ("jax", "port")):
        out = tmp_path / tag / answer_name
        calls[tag] = []

        def traced(*a, _calls=calls[tag], **kw):
            _calls.append((a, kw))
            return infer(*a, **kw)

        bench().run(_Args(answer_file=str(out), **args_kw), processor, traced)
        texts[tag] = [out.read_text()] + [(tmp_path / tag / f).read_text() for f in extra_files]
    return texts["port"], texts["jax"], calls["port"], calls["jax"]


def test_activitynet_oqa_runner(tmp_path):
    vids = tmp_path / "videos"
    vids.mkdir()
    (vids / "v_abc.mp4").write_bytes(b"")
    (vids / "xyz.webm").write_bytes(b"")
    qf = tmp_path / "q.json"
    qf.write_text(json.dumps([{"video_name": "abc", "question": "q-abc", "question_id": 1},
                              {"video_name": "xyz", "question": "q-xyz", "question_id": 2}]))
    gf = tmp_path / "a.json"
    gf.write_text(json.dumps([{"answer": "ans-abc"}, {"answer": "ans-xyz"}]))
    got, ref, calls, ref_calls = run_both(
        tmp_path, "ActivityNetOQA", dict(question_file=str(qf), answer_gt_file=str(gf), video_folder=str(vids)),
        _fake_processor(), lambda t, q, modal=None, guide_instruct=None: f"pred:{q}")
    assert got == ref and calls == ref_calls
    recs = [json.loads(line) for line in got[0].splitlines()]
    assert [r["question_id"] for r in recs] == [1, 2]
    assert recs[0]["answer"] == "ans-abc" and recs[0]["pred"] == "pred:q-abc"


def test_vcgpt_general_runner(tmp_path):
    vids = tmp_path / "videos"
    vids.mkdir()
    (vids / "clip.mkv").write_bytes(b"")
    qf = tmp_path / "q.json"
    qf.write_text(json.dumps([{"video_name": "clip", "question": "what happens?", "question_id": 3},
                              {"video_name": "clip", "question": "and then?"}]))
    got, ref, calls, ref_calls = run_both(tmp_path, "VCGPTGeneral",
                                          dict(question_file=str(qf), video_folder=str(vids)),
                                          _fake_processor(), lambda t, q, **kw: f"p:{q}")
    assert got == ref and calls == ref_calls


def test_vcgpt_consistency_runner(tmp_path):
    vids = tmp_path / "videos"
    vids.mkdir()
    (vids / "clip.mp4").write_bytes(b"")
    qf = tmp_path / "q.json"
    qf.write_text(json.dumps([{"video_name": "clip", "Q1": "ask one", "Q2": "ask two", "A": "truth"}]))
    got, ref, calls, ref_calls = run_both(tmp_path, "VCGPTConsistency",
                                          dict(question_file=str(qf), video_folder=str(vids)),
                                          _fake_processor(), lambda t, q, **kw: f"p:{q}")
    assert got == ref and calls == ref_calls
    assert json.loads(got[0]) == {"video_name": "clip", "Q1": "ask one", "Q2": "ask two", "A": "truth",
                                  "P1": "p:ask one", "P2": "p:ask two"}


def test_msvc_runner(tmp_path):
    vids = tmp_path / "videos"
    (vids / "sub").mkdir(parents=True)
    (vids / "sub" / "v1.mp4").write_bytes(b"")
    qf = tmp_path / "q.json"
    qf.write_text(json.dumps([{"video_path": "sub/v1.mp4", "captions": ["c1", "c2"]}]))
    got, ref, calls, ref_calls = run_both(tmp_path, "MSVCCaption", dict(question_file=str(qf), video_folder=str(vids)),
                                          _fake_processor(), lambda t, q, **kw: "a caption")
    assert got == ref and calls == ref_calls
    rec = json.loads(got[0])
    assert rec["video_name"] == "v1" and rec["answer"] == ["c1", "c2"] and rec["pred"] == "a caption"


def test_videomme_runner_end_to_end(tmp_path):
    import cv2
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pa.table({
        "video_id": ["1", "1", "2"],
        "videoID": ["ytid01", "ytid01", "ytid02"],
        "url": ["https://www.youtube.com/watch?v=ytid01"] * 2 + ["https://www.youtube.com/watch?v=ytid02"],
        "duration": ["short"] * 3,
        "domain": ["Knowledge"] * 3,
        "sub_category": ["Law"] * 3,
        "question_id": ["1-1", "1-2", "2-1"],
        "task_type": ["Action Recognition"] * 3,
        "question": ["What color?", "How many?", "Where?"],
        "options": [["A. red.", "B. blue.", "C. green.", "D. pink."],
                    ["A. one.", "B. two.", "C. three.", "D. seven."],
                    ["A. here.", "B. there.", "C. up.", "D. down."]],
        "answer": ["B", "D", "A"],
    })
    qf = tmp_path / "test.parquet"
    pq.write_table(table, str(qf))
    vids = tmp_path / "videos"
    vids.mkdir()
    vw = cv2.VideoWriter(str(vids / "ytid01.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (64, 64))
    assert vw.isOpened()
    for _ in range(50):
        vw.write(np.zeros((64, 64, 3), np.uint8))
    vw.release()
    subs = tmp_path / "subs"
    subs.mkdir()
    (subs / "ytid01.srt").write_text("1\n00:00:00,000 --> 00:00:01,000\nhello subtitle\n\n"
                                     "2\n00:00:01,500 --> 00:00:02,000\n<i>styled</i> line\n\n")

    def infer(tensor, instruct, modal=None, guide_instruct=None):
        return "The best answer is (B)." if "color" in instruct else "seven"

    def video(path, **kw):  # ytid02 has no file: its record is "missing"
        if path is None:
            raise FileNotFoundError("no video")
        return np.zeros((8, 3, 8, 8), np.float32)

    got, ref, calls, ref_calls = run_both(
        tmp_path, "VideoMME", dict(question_file=str(qf), video_folder=str(vids), subtitle_folder=str(subs)),
        {"video": video}, infer, answer_name="preds.json", extra_files=("preds_sub.json",))
    assert got == ref
    assert [c[0][1:] for c in calls] == [c[0][1:] for c in ref_calls] and len(calls) == 4
    merge = both("eval.common", "merge_chunked_videomme")[1]
    recs = merge([str(tmp_path / "port" / "preds.json")])
    assert recs[0]["missing"] is False and recs[1]["missing"] is True
    assert [q["response"] for q in recs[0]["questions"]] == ["B", "D"]
    assert any("hello subtitle" in c[0][1] for c in calls)


def test_image_vqa_runner(tmp_path, monkeypatch):
    import uuid

    imgs = tmp_path / "images"
    imgs.mkdir()
    (imgs / "0001.jpg").write_bytes(b"")
    suffix = "\nAnswer the question using a single word or phrase."
    qf = tmp_path / "q.jsonl"
    qf.write_text(json.dumps({"question_id": 7, "image": "0001.jpg", "text": "Is there a dog?" + suffix}) + "\n")
    # the answer ids are random: the same ones for both packages
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=12345))
    got, ref, calls, ref_calls = run_both(
        tmp_path, "ImageVQA", dict(question_file=str(qf), image_folder=str(imgs), sub_benchmark="pope",
                                   model_id="hicom-test"),
        {"image": lambda path, **kw: (f"tensor<{path}>", [(64, 48)])},
        lambda tensor, instruct, modal=None, image_size=None, guide_instruct=None: "yes")
    assert got == ref
    assert [c[1] for c in calls] == [c[1] for c in ref_calls]
    rec = json.loads(got[0])
    assert rec["question_id"] == 7 and rec["text"] == "yes" and len(rec["answer_id"]) == 22
    assert calls[0][1] == {"modal": "image", "image_size": (64, 48), "guide_instruct": "Is there a dog?"}


def test_mvbench_runner(tmp_path):
    from hicom_tpu_torch.eval.benchmarks import MVBENCH_TASKS

    assert MVBENCH_TASKS == both("eval.benchmarks", "MVBENCH_TASKS")[0]
    qdir = tmp_path / "json"
    qdir.mkdir()
    vids = tmp_path / "videos"
    for task, (json_file, folder, data_type, has_bound) in MVBENCH_TASKS.items():
        (vids / folder).mkdir(parents=True, exist_ok=True)
        (qdir / json_file).write_text("[]")
    (qdir / "action_sequence.json").write_text(json.dumps([{
        "video": "c1.mp4", "question": "What first?", "candidates": ["jump", "sit"], "answer": "sit",
        "start": 1.5, "end": 9.0}]))
    (qdir / "action_count.json").write_text(json.dumps([{
        "video": "c2.mp4", "question": "How many?", "candidates": ["one", "two", "three"], "answer": "three"}]))
    proc_calls = []

    def video_proc(path, s=None, e=None, **kw):
        proc_calls.append((os.path.basename(path), s, e))
        return np.zeros((4, 3, 4, 4))

    got, ref, calls, ref_calls = run_both(tmp_path, "MVBench", dict(question_file=str(qdir), video_folder=str(vids)),
                                          {"video": video_proc}, lambda t, q, **kw: "(B)")
    assert got == ref and [c[0][1:] for c in calls] == [c[0][1:] for c in ref_calls]
    by_task = {r["task_type"]: r for r in map(json.loads, got[0].splitlines())}
    assert by_task["Action Sequence"]["pred"] == 1 and by_task["Action Count"]["gt"] == 2
    bounds = {p: (s, e) for p, s, e in proc_calls}
    assert bounds["c1.mp4"] == (1.5, 9.0) and bounds["c2.mp4"] == (None, None)


def test_mvbench_runner_batched(tmp_path):
    """``--batch-size 2``: ``run_mcqa`` hands same-shape clips to
    ``infer_batch``; both packages batch and record alike."""
    from hicom_tpu_torch.eval.benchmarks import MVBENCH_TASKS

    qdir = tmp_path / "json"
    qdir.mkdir()
    vids = tmp_path / "videos"
    for task, (json_file, folder, _, _) in MVBENCH_TASKS.items():
        (vids / folder).mkdir(parents=True, exist_ok=True)
        (qdir / json_file).write_text(json.dumps([{
            "video": f"{i}.mp4", "question": f"{task} {i}?", "candidates": ["a", "b", "c"], "answer": "c",
            "start": 0.5, "end": 3.0}
            for i in range(3 if task == "Action Antonym" else 1)]))
    texts, batches = {}, {}
    for bench, tag in zip(both("eval.benchmarks", "MVBench"), ("jax", "port")):
        batches[tag] = []

        def infer_batch(tensors, instructs, guides, _b=batches[tag]):
            _b.append((len(tensors), list(instructs), list(guides)))
            return ["(C)" if i % 2 else "A" for i in range(len(tensors))]

        out = tmp_path / f"{tag}.jsonl"
        args = _Args(question_file=str(qdir), video_folder=str(vids), answer_file=str(out), batch_size=2,
                     infer_batch=infer_batch)
        bench().run(args, {"video": lambda p, **kw: np.zeros((4, 3, 4, 4))}, lambda *a, **kw: "unused")
        texts[tag] = out.read_text()
    assert texts["port"] == texts["jax"] and batches["port"] == batches["jax"]
    assert {n for n, _, _ in batches["port"]} == {2}


def test_mlvu_runner_deterministic_shuffle(tmp_path):
    from hicom_tpu_torch.eval.benchmarks import MLVU_TASKS

    assert MLVU_TASKS == both("eval.benchmarks", "MLVU_TASKS")[0]
    qdir = tmp_path / "json"
    qdir.mkdir()
    vids = tmp_path / "videos"
    for n, (task, (json_file, folder, _)) in enumerate(MLVU_TASKS.items()):
        (vids / folder).mkdir(parents=True, exist_ok=True)
        (qdir / json_file).write_text(json.dumps([{
            "video": f"v{n}.mp4", "question": f"q{n}", "candidates": ["a", "b"], "answer": "b"}]))
    got, ref, calls, ref_calls = run_both(tmp_path, "MLVU", dict(question_file=str(qdir), video_folder=str(vids)),
                                          {"video": lambda p, **kw: np.zeros((4, 3, 4, 4))}, lambda t, q, **kw: "A")
    assert got == ref
    recs = [json.loads(line) for line in got[0].splitlines()]
    assert len(recs) == len(MLVU_TASKS) and all(r["pred"] == 0 and r["gt"] == 1 for r in recs)


def test_egoschema_runner(tmp_path):
    vids = tmp_path / "videos"
    vids.mkdir()
    (vids / "uid123.mp4").write_bytes(b"")
    qf = tmp_path / "q.json"
    qf.write_text(json.dumps([{"q_uid": "uid123", "question": "What happened?",
                               **{f"option {i}": f"opt{i}" for i in range(5)}}]))
    got, ref, calls, ref_calls = run_both(
        tmp_path, "EgoSchema", dict(question_file=str(qf), video_folder=str(vids)),
        {"video": lambda p, **kw: np.zeros((4, 3, 4, 4))},
        lambda tensor, instruct, modal=None, guide_instruct=None: "The best choice is (E).", answer_name="out.csv")
    assert got == ref == ["uid123, 4\n"]
    assert [c[0][1] for c in calls] == [c[0][1] for c in ref_calls]


def test_registry_matches_jax():
    jax_reg, reg = both("eval.benchmarks", "REGISTRY")
    assert sorted(reg) == sorted(jax_reg)
    assert all(reg[k].__name__ == jax_reg[k].__name__ for k in reg)


def test_score_cli_matches_jax(tmp_path, capsys):
    path = tmp_path / "preds.jsonl"
    path.write_text("\n".join(json.dumps({"task_type": "Action Count", "pred": i % 2, "gt": 1}) for i in range(5)))
    outs = []
    for score in both("eval.score"):
        score.main(["--benchmark", "mvbench", "--results", str(path)])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and json.loads(outs[1])["overall"] == 40.0


# --------------------------------------------------------------------------- #
# conversation templates, prompt ids, prefetch
# --------------------------------------------------------------------------- #


def test_conversation_templates_match_jax():
    jax_conv, conv = both("conversation")
    assert sorted(conv.conv_templates) == sorted(jax_conv.conv_templates)
    for name in sorted(conv.conv_templates):
        prompts = []
        for templates in (jax_conv.conv_templates, conv.conv_templates):
            c = templates[name].copy()
            c.append_message(c.roles[0], "hi <video> there")
            c.append_message(c.roles[1], "hello!")
            c.append_message(c.roles[0], "again?")
            c.append_message(c.roles[1], None)
            prompts.append((c.get_prompt(), c.dict()))
            if c.sep_style.name not in ("LLAMA2", "QWEN"):  # the image tuple form of the first turn
                c = templates[name].copy()
                c.append_message(c.roles[0], ("<image> what is it", "image", "pad"))
                c.append_message(c.roles[1], None)
                prompts.append((c.get_prompt(), c.dict()))
        assert prompts[: len(prompts) // 2] == prompts[len(prompts) // 2:], name


def test_mm_infer_prompt_ids_match_jax():
    jax_fn, fn = both("data.prompts", "tokenizer_multimodal_token")

    class Tok:
        pad_token_id = 0

        def __call__(self, text, add_special_tokens=False):
            return type("R", (), {"input_ids": [sum(map(ord, w)) % 997 + 5 for w in text.split()]})()

    tok = Tok()
    for modal_token, prompt in [("<video>", "<|im_start|>user\n<video>\nWhat happens?<|im_end|>\n"),
                                ("<image>", "<image>\nDescribe the scene . <image> again")]:
        np.testing.assert_array_equal(np.asarray(fn(prompt, tok, modal_token, return_tensors="np")),
                                      np.asarray(jax_fn(prompt, tok, modal_token, return_tensors="np")))


def test_prefetched_multiworker_order_and_bound():
    import threading
    import time as _time

    jax_fn, fn = both("eval.benchmarks", "_prefetched")
    in_flight, peak, lock = [0], [0], threading.Lock()

    def prepare(i):
        with lock:
            in_flight[0] += 1
            peak[0] = max(peak[0], in_flight[0])
        _time.sleep(0.002 * (i % 3))
        with lock:
            in_flight[0] -= 1
        return i * 10

    items = list(range(24))
    out = list(fn(items, prepare, workers=4))
    assert out == list(jax_fn(items, prepare, workers=4)) == [i * 10 for i in items]
    assert peak[0] <= 5
    assert list(fn([], prepare)) == list(jax_fn([], prepare)) == []
    assert list(fn([1, 2], prepare, workers=1)) == [10, 20]
