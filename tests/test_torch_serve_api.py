"""``mm_infer_batch`` and ``mm_serve`` of the port against the JAX package's, on one exported checkpoint.

A tiny guide-mode JAX model is written by ``hicom_tpu.weights.export_hf_checkpoint``
(fp32, reference layout) beside a word-level tokenizer, as
``tests/test_torch_api.py`` writes it; ``hicom_tpu_torch.load_model(...,
device="cpu")`` loads the same directory. Both packages' batched and
continuous-batching entry points must return the same strings (greedy), the
serving one with and without speculative rounds.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hicom_tpu import config as jcfg
from hicom_tpu.models.hicom import HIComModel as JModel

VIDEO = -201
WORDS = ["what", "is", "in", "the", "video", "?", "a", "cat", "dog", "red", "USER:", "ASSISTANT:", "<video>",
         "describe", "image", "say", "hello"]


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
def loaded(tmp_path_factory):
    """(JAX HICom, port HICom, tokenizer) on one exported checkpoint."""
    from transformers import AutoTokenizer

    import hicom_tpu
    import hicom_tpu_torch
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
    jm = JModel(config=cfg)
    params = jax.jit(lambda i, f, g: jm.init(jax.random.PRNGKey(4), i, f, guide_ids=g))(
        jnp.asarray(ids), jnp.asarray(rng.standard_normal((1, 4, 3, 56, 56)), jnp.float32),
        jnp.asarray(rng.integers(1, 10, (1, 16))))["params"]
    export_hf_checkpoint(jax.device_get(params), cfg, str(ckpt), dtype="float32")
    jhc, _, tok = hicom_tpu.model_init(str(ckpt), dtype="float32", cache_len=512)
    thc = hicom_tpu_torch.load_model(str(ckpt), dtype="float32", cache_len=512, device="cpu")
    return jhc, thc, AutoTokenizer.from_pretrained(str(ckpt))


@pytest.mark.parametrize("modal", ["video", "image"])
def test_mm_infer_batch_strings_match_jax(loaded, modal):
    """Two same-shape inputs with prompts of different lengths (right-padded
    into one batch) and per-row guide ids."""
    from hicom_tpu.api import mm_infer_batch as j_batch
    from hicom_tpu_torch.api import mm_infer_batch as t_batch

    jhc, thc, tok = loaded
    rng = np.random.default_rng(12)
    t = 4 if modal == "video" else 1
    tensors = [rng.standard_normal((t, 3, 56, 56)).astype(np.float32) for _ in range(2)]
    instructs = ["what is in the video ?", "describe the red cat in the image ?"]
    kw = dict(modal=modal, guide_ids=rng.integers(1, 10, (2, 16)), max_new_tokens=8)
    ref = j_batch(tensors, instructs, jhc, tok, **kw)
    got = t_batch(tensors, instructs, thc, tok, **kw)
    assert any(ref) and got == ref


@pytest.mark.parametrize("spec_k", [0, 3])
def test_mm_serve_strings_match_jax(loaded, spec_k):
    """Two videos, an image and two text prompts with mixed budgets through 2
    slots (slots refill mid-run), one stop string: the strings equal JAX's
    ``mm_serve``."""
    from hicom_tpu.api import mm_serve as j_serve
    from hicom_tpu_torch.api import mm_serve as t_serve

    jhc, thc, tok = loaded
    rng = np.random.default_rng(13)
    video = lambda: rng.standard_normal((4, 3, 56, 56)).astype(np.float32)  # noqa: E731
    samples = [
        dict(instruct="what is in the video ?", tensor=video(), guide_ids=rng.integers(1, 10, 16), max_new_tokens=9),
        dict(instruct="say hello", max_new_tokens=5),
        dict(instruct="describe the image", tensor=video()[:1], modal="image", guide_ids=rng.integers(1, 10, 16),
             max_new_tokens=12),
        dict(instruct="is the dog red ?", tensor=video(), guide_ids=rng.integers(1, 10, 16), max_new_tokens=7),
        dict(instruct="what is a cat ?", max_new_tokens=10),
    ]
    kw = dict(n_slots=2, sync_steps=3, spec_k=spec_k, stop_strings=["cat"])
    ref = j_serve(samples, jhc, tok, **kw)
    got = t_serve(samples, thc, tok, **kw)
    assert any(ref) and got == ref
