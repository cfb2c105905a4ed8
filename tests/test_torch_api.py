"""``hicom_tpu_torch.mm_infer`` against ``hicom_tpu.mm_infer`` on one exported checkpoint.

A tiny JAX model is written by ``hicom_tpu.weights.export_hf_checkpoint``
(fp32, reference layout) beside a word-level tokenizer, with no downloads;
``hicom_tpu_torch.load_model(..., device="cpu")`` loads the same directory,
and both packages' ``mm_infer`` must return the same string.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hicom_tpu import config as jcfg
from hicom_tpu.models.hicom import HIComModel as JModel

VIDEO = -201


WORDS = ["what", "is", "in", "the", "video", "?", "a", "cat", "dog", "red", "USER:", "ASSISTANT:", "<video>"]


def _word_tokenizer(path, words, extra=None):
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<pad>": 1, "</s>": 2}
    for i, w in enumerate(words):
        vocab[w] = 3 + i
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.save(str(path / "tokenizer.json"))
    cfg = {"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>", "pad_token": "<pad>",
           "eos_token": "</s>"}
    cfg.update(extra or {})
    with open(path / "tokenizer_config.json", "w") as f:
        json.dump(cfg, f)
    return len(vocab)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    from hicom_tpu.weights import export_hf_checkpoint

    root = tmp_path_factory.mktemp("export")
    tower = root / "siglip-so400m-patch14-384"  # the name keys the tower geometry
    ckpt = root / "HICom_tiny_sft"
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
    _word_tokenizer(tower, WORDS[:8], {"model_max_length": 64})
    n_vocab = _word_tokenizer(ckpt, WORDS, {
        "chat_template": "{% for m in messages %}{{ m['content'] }}\n{% endfor %}"
                         "{% if add_generation_prompt %}ASSISTANT:{% endif %}"})
    # the decoder's vocabulary is the tokenizer's, so every generated id decodes to a word
    cfg = base.replace(text_config=jcfg.Qwen2Config(**{**base.text_config.__dict__, "vocab_size": n_vocab}),
                       use_guide="direct", mm_vision_tower=str(tower))
    rng = np.random.default_rng(4)
    ids = rng.integers(3, n_vocab, (1, 10))
    ids[0, 2] = VIDEO
    params = JModel(config=cfg).init(
        jax.random.PRNGKey(4), jnp.asarray(ids), jnp.asarray(rng.standard_normal((1, 4, 3, 56, 56)), jnp.float32),
        guide_ids=jnp.asarray(rng.integers(1, 10, (1, 16))))["params"]
    export_hf_checkpoint(jax.device_get(params), cfg, str(ckpt), dtype="float32")
    return str(ckpt)


@pytest.mark.parametrize("modal", ["video", "text"])
def test_mm_infer_string_matches_jax(exported, modal):
    from transformers import AutoTokenizer

    import hicom_tpu
    import hicom_tpu_torch

    rng = np.random.default_rng(11)
    video = rng.standard_normal((4, 3, 56, 56)).astype(np.float32) if modal == "video" else None
    gids = rng.integers(1, 10, (1, 16))
    kw = dict(modal=modal, guide_ids=gids, max_new_tokens=8)
    jhc, _, tok = hicom_tpu.model_init(exported, dtype="float32", cache_len=256)
    ref = hicom_tpu.mm_infer(video, "what is in the video ?", jhc, tok, **kw)
    thc = hicom_tpu_torch.load_model(exported, dtype="float32", cache_len=256, device="cpu")
    got = hicom_tpu_torch.mm_infer(video, "what is in the video ?", thc,
                                   AutoTokenizer.from_pretrained(exported), **kw)
    assert ref and got == ref  # non-empty: the seeded model emits words before eos
    assert thc.guide_tokenizer is not None
