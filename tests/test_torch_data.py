"""The port's host data pipeline against the JAX package's: exact equality.

``hicom_tpu_torch.data`` and ``hicom_tpu_torch.train.dataset`` are copies of
numpy/PIL/ctypes code, so every array must be bitwise equal to JAX's and every
id list, label list and batch order identical, on the same files and seeds.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from hicom_tpu.data import image as jimage
from hicom_tpu.data import processor as jproc
from hicom_tpu.data import prompts as jprompts
from hicom_tpu.data import video as jvideo
from hicom_tpu.train import dataset as jds
from hicom_tpu_torch.data import image as timage
from hicom_tpu_torch.data import processor as tproc
from hicom_tpu_torch.data import prompts as tprompts
from hicom_tpu_torch.data import video as tvideo
from hicom_tpu_torch.train import dataset as tds

SIZE = 56


class WordTokenizer:
    """Word-level ids and a role-tagged chat template (numpy only)."""

    pad_token_id = 0

    def __call__(self, text, add_special_tokens=False):
        return type("Enc", (), {"input_ids": [sum(map(ord, w)) % 997 + 3 for w in text.split()]})()

    def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=False):
        s = "".join(f"<|{m['role']}|> {m['content']} <|end|> " for m in messages)
        return (s + "<|assistant|> " if add_generation_prompt else s).strip()


def _guide_tokenizer(path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<unk>": 0, "<pad>": 1}
    for i, w in enumerate("what does the cat do in this video describe picture".split()):
        vocab[w] = 2 + i
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.save(str(path / "tokenizer.json"))
    return PreTrainedTokenizerFast(tokenizer_file=str(path / "tokenizer.json"), unk_token="<unk>",
                                   pad_token="<pad>", model_max_length=12)


def _procs(use_native="never"):
    return (jproc.SiglipImagePreprocessor(size=(SIZE, SIZE), use_native=use_native),
            tproc.SiglipImagePreprocessor(size=(SIZE, SIZE), use_native=use_native))


def _image(path, seed, hw=(30, 40)):
    Image.fromarray(np.random.default_rng(seed).integers(0, 255, hw + (3,), dtype=np.uint8)).save(path)
    return str(path)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("aspect,hw", [("pad", (30, 40)), ("pad", (48, 20)), (None, (30, 40)), ("pad", (56, 56))])
def test_process_image_matches_jax(tmp_path, aspect, hw):
    path = _image(tmp_path / "a.png", 1, hw)
    jp, tp = _procs()
    (ja, js), (ta, ts) = jimage.process_image(path, jp, aspect), timage.process_image(path, tp, aspect)
    _equal(ja, ta)
    assert js == ts


@pytest.mark.parametrize("use_native", ["always", "never", "auto"])
def test_siglip_preprocessor_routes_match_jax(use_native):
    frames = np.random.default_rng(2).integers(0, 255, (3, 37, 37, 3), dtype=np.uint8)
    jp, tp = _procs(use_native)
    _equal(jp.preprocess(list(frames))["pixel_values"], tp.preprocess(list(frames))["pixel_values"])


def test_anyres_geometry_matches_jax():
    res = jimage.parse_grid_pinpoints("(1x1),...,(3x3)", 384)
    assert res == timage.parse_grid_pinpoints("(1x1),...,(3x3)", 384)
    for size in [(640, 480), (300, 900), (1000, 1000)]:
        assert jimage.select_best_resolution(size, res) == timage.select_best_resolution(size, res)
        assert (jimage.get_anyres_image_grid_shape(size, res, 384)
                == timage.get_anyres_image_grid_shape(size, res, 384))
    img = Image.fromarray(np.random.default_rng(3).integers(0, 255, (50, 70, 3), dtype=np.uint8))
    for j, t in zip(jimage.divide_to_patches(jimage.resize_and_pad_image(img, (96, 64)), 32),
                    timage.divide_to_patches(timage.resize_and_pad_image(img, (96, 64)), 32)):
        _equal(np.asarray(j), np.asarray(t))


def _video_inputs(tmp_path, kind):
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (12, 30, 40, 3), dtype=np.uint8)
    if kind == "dir":
        d = tmp_path / "frames"
        d.mkdir()
        for i, f in enumerate(frames):
            Image.fromarray(f).save(d / f"{i:03d}.png")
        return str(d), dict(num_frames=5)
    if kind == "array":
        return frames, dict(num_frames=12)
    if kind == "pil_list":
        return [Image.fromarray(f) for f in frames[:6]], dict(num_frames=6)
    if kind == "pad_short":  # fewer frames than num_frames: black frames appended
        return frames[:3], dict(num_frames=8)
    if kind == "cap_long":  # more frames than max_frames: cut
        return list(frames), dict(num_frames=None, max_frames=4)
    if kind == "mp4":
        import cv2

        path = str(tmp_path / "clip.mp4")  # 128 x 96: the native reader's tests use this geometry
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (128, 96))
        for f in rng.integers(0, 255, (12, 96, 128, 3), dtype=np.uint8):
            vw.write(f)
        vw.release()
        return path, dict(num_frames=4, s=0.0, e=0.3)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["dir", "array", "pil_list", "pad_short", "cap_long", "mp4"])
def test_process_video_matches_jax(tmp_path, kind):
    src, kw = _video_inputs(tmp_path, kind)
    jp, tp = _procs()
    _equal(jvideo.process_video(src, jp, **kw), tvideo.process_video(src, tp, **kw))


def test_process_video_raw_ingest_waits_for_device_preprocess():
    # raw ingest hands the device preprocessor decoded uint8 frames (ops/preprocess.py), as JAX's does
    frames = np.random.default_rng(6).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = tvideo.process_video(frames, None, num_frames=2)
    assert got.dtype == np.uint8 and got.shape == (2, 8, 8, 3)
    _equal(jvideo.process_video(frames, None, num_frames=2), got)


@pytest.mark.parametrize("mode,kw", [("uniform", dict(num_frames=8)), ("uniform", dict(num_frames=3)),
                                     ("fps", dict(fps=30)), ("fps", dict(fps=2))])
def test_frame_sample_matches_jax(mode, kw):
    for duration in (1, 7, 100, 301):
        _equal(jvideo.frame_sample(duration, mode, **kw), tvideo.frame_sample(duration, mode, **kw))


PROMPTS = [
    "<video>\nWhat does the cat do?",
    "<image>\nQuestion: Which color?\nOptions:\n(A) red\n(B) blue",
    "<video>What happens?\nA. run\nB. sit\nPlease respond with only the letter of the correct answer.",
    "Pick the relevant category from the list of options. Options:\n1. a",
    "Describe it. Answer the question using a single word or phrase.",
    "Is it\nOptions:\n(A) yes\nQuestion: really?",
]


def test_prompt_helpers_match_jax():
    assert tprompts.OPTION_PROMPT_LIST == jprompts.OPTION_PROMPT_LIST
    for p in PROMPTS:
        assert tprompts.extract_guided_prompt(p) == jprompts.extract_guided_prompt(p), p
    for path in ("a/b/HICom-7B", "/x/HICom/checkpoint-200/", "model"):
        assert tprompts.get_model_name_from_path(path) == jprompts.get_model_name_from_path(path)
    tok = WordTokenizer()
    for p, token in [(PROMPTS[0], "<video>"), (PROMPTS[1], "<image>"), ("no tag here", "<audio>")]:
        assert (tprompts.tokenizer_multimodal_token(p, tok, token)
                == jprompts.tokenizer_multimodal_token(p, tok, token))
    for sample in _rows()[:4] + [{"video": "v", "conversations": [{"from": "human", "value": "x"}]}]:
        a, b = json.loads(json.dumps(sample)), json.loads(json.dumps(sample))
        assert tprompts.convert_guide_format(a) == jprompts.convert_guide_format(b)


def _rows():
    conv = [{"from": "human", "value": "<image> describe the picture"}, {"from": "gpt", "value": "a red cat"},
            {"from": "human", "value": "and then ?"}, {"from": "gpt", "value": "it sits"}]
    rows = []
    for i in range(4):
        rows.append({"image": f"{i}.png", "conversations": conv[:2] if i % 2 else conv})
        rows.append({"video": f"v{i}", "conversations": [{"from": "human", "value": "what does the cat do"},
                                                         {"from": "gpt", "value": "it " + "runs " * (i + 1)}]})
    rows.append({"conversations": [{"from": "human", "value": "hi"}, {"from": "gpt", "value": "hello"}]})
    return rows


def test_preprocess_plain_matches_jax():
    tok = WordTokenizer()
    src = [[{"from": "human", "value": "<image>"}, {"from": "gpt", "value": "a red cat"}],
           [{"from": "human", "value": "<video>\n"}, {"from": "gpt", "value": "runs fast"}]]
    for token, s in (("<image>", src[:1]), ("<video>", src[1:])):
        for a, b in zip(jds.preprocess_plain(s, tok, token), tds.preprocess_plain(s, tok, token)):
            for x, y in zip(a, b):
                _equal(x, y)


@pytest.mark.parametrize("guided", [False, True])
def test_preprocess_chat_matches_jax(guided):
    tok = WordTokenizer()
    src = [[{"from": "gpt", "value": "skipped"}] + _rows()[0]["conversations"], _rows()[1]["conversations"]]
    for a, b in zip(jds.preprocess_chat(src, tok, "<image>", guided), tds.preprocess_chat(src, tok, "<image>", guided)):
        for x, y in zip(a, b):
            _equal(x, y)


@pytest.mark.parametrize("kind", ["json", "jsonl", "yaml"])
def test_load_mixture_matches_jax(tmp_path, kind):
    rows = [{"id": i, "video": f"v{i}.mp4", "conversations": []} for i in range(10)]
    if kind == "yaml":
        pytest.importorskip("yaml")
        (tmp_path / "a.json").write_text(json.dumps(rows))
        (tmp_path / "b.jsonl").write_text("\n".join(json.dumps(r) for r in rows[:6]))
        (tmp_path / "mix.yaml").write_text(
            f"datasets:\n  - json_path: {tmp_path / 'a.json'}\n    sampling_strategy: random:30%\n"
            f"    data_root: /data\n  - json_path: {tmp_path / 'b.jsonl'}\n    sampling_strategy: end:2\n"
            f"  - json_path: {tmp_path / 'a.json'}\n    sampling_strategy: first:3\n")
        paths = [str(tmp_path / "mix.yaml")]
    elif kind == "json":
        (tmp_path / "a.json").write_text(json.dumps(rows))
        paths = [str(tmp_path / "a.json")] * 2
    else:
        (tmp_path / "b.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
        paths = [str(tmp_path / "b.jsonl")]
    for seed in (0, 42):
        assert tds.load_mixture(paths, seed) == jds.load_mixture(paths, seed)


def test_split_guide_format_matches_jax():
    rows = _rows() + [{"image": "x", "conversations": [{"from": "human", "value": "odd"}]}]
    assert tds.split_guide_format(json.loads(json.dumps(rows))) == jds.split_guide_format(json.loads(json.dumps(rows)))


def _dataset_files(tmp_path, rows):
    for i in range(4):
        _image(tmp_path / f"{i}.png", 10 + i, (30 + 4 * i, 40))
        d = tmp_path / f"v{i}"
        d.mkdir()
        for j in range(3 + i):
            _image(d / f"{j}.png", 100 * i + j, (32, 24))
    data = tmp_path / "data.json"
    data.write_text(json.dumps(rows))
    return str(data)


def _both(tmp_path, rows=None, **kw):
    data = _dataset_files(tmp_path, rows or _rows())
    gt = _guide_tokenizer(tmp_path) if kw.get("use_guide") else None
    out = []
    for mod, proc in ((jds, _procs()[0]), (tds, _procs()[1])):
        args = mod.DataArguments(data_path=[data], data_folder=str(tmp_path), num_frames=4, image_size=SIZE,
                                 length_bucket=8, **kw)
        out.append((mod.SupervisedDataset(WordTokenizer(), args, proc), mod.Collator(WordTokenizer(), args, gt)))
    return out


def _same_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            _equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kw", [dict(), dict(is_pretraining=True, use_guide=None), dict(use_guide="direct")],
                         ids=["chat", "pretrain", "guide"])
def test_dataset_items_and_batches_match_jax(tmp_path, kw):
    rows = None
    if kw.get("is_pretraining"):  # plain preprocessing takes one human/gpt pair with the modal tag
        rows = [r for r in _rows() if "image" in r and len(r["conversations"]) == 2]
    (jd, jc), (td, tc) = _both(tmp_path, rows, **kw)
    assert len(jd) == len(td) and jd.modality_lengths == td.modality_lengths
    for i in range(len(jd)):
        assert jd.modality_of(i) == td.modality_of(i)
        _same_items(jd[i], td[i])
    for seed in (0, 7):
        jb = list(jds.iter_batches(jd, jc, 2, seed=seed))
        tb = list(tds.iter_batches(td, tc, 2, seed=seed))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            _same_items(a, b)
    if kw.get("use_guide"):
        assert "guide_ids" in tb[0] and "guide_mask" in tb[0]


def test_corrupt_sample_retries_another(tmp_path, monkeypatch):
    (jd, _), (td, _) = _both(tmp_path)
    os.remove(tmp_path / "0.png")  # row 0's image is gone: the item comes from a random other row
    import random

    random.seed(3)
    ref = jd[0]
    random.seed(3)
    _same_items(ref, td[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_indices_match_jax(seed):
    lengths = list(np.random.default_rng(seed).integers(1, 50, 23) * np.where(np.arange(23) % 3, 1, -1))
    for bs in (1, 4):
        assert (tds.modality_length_grouped_indices(lengths, bs, 1, seed)
                == jds.modality_length_grouped_indices(lengths, bs, 1, seed))
    pos = [abs(x) for x in lengths]
    assert tds.modality_length_grouped_indices(pos, 4, 2, seed) == jds.modality_length_grouped_indices(pos, 4, 2, seed)
    assert tds.split_to_even_chunks(list(range(8)), pos, 4) == jds.split_to_even_chunks(list(range(8)), pos, 4)
