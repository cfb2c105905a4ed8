"""``mm_infer``'s sequence-parallel route against the JAX package, in four gloo ranks.

A tiny guide-mode JAX model is exported with a word-level tokenizer, as
``tests/test_torch_api.py`` exports it (its init jitted here). ``mm_infer`` answers a
question about a 64-frame video:

* JAX's on the 8 virtual CPU devices, which routes it through
  ``HICom.encode_long_video`` (64 > 32 frames, 64 % (8 x 4) == 0);
* the port's in 4 gloo rank processes (``tests/torch_ranks.seq_api_worker``):
  with ``HICOM_SEQ_PARALLEL`` unset it takes ``encode_long_video`` (counted
  by a wrapper) on every rank and gives JAX's string; with
  ``HICOM_SEQ_PARALLEL=0``, and for a 60-frame video (60 % (4 x 4) != 0), it
  keeps the single pass;
* the port's in this one process, which has one rank and never routes.
"""

import numpy as np
import pytest
import torch

import torch_ranks as R
from test_torch_api import VIDEO, WORDS, _word_tokenizer

QUESTION = "what is in the video ?"
WORLD = 4


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    import json

    import jax
    import jax.numpy as jnp

    from hicom_tpu import config as jcfg
    from hicom_tpu.models.hicom import HIComModel as JModel
    from hicom_tpu.weights import export_hf_checkpoint

    root = tmp_path_factory.mktemp("export")
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
    _word_tokenizer(tower, WORDS[:8], {"model_max_length": 64})
    n_vocab = _word_tokenizer(ckpt, WORDS, {
        "chat_template": "{% for m in messages %}{{ m['content'] }}\n{% endfor %}"
                         "{% if add_generation_prompt %}ASSISTANT:{% endif %}"})
    cfg = base.replace(text_config=jcfg.Qwen2Config(**{**base.text_config.__dict__, "vocab_size": n_vocab}),
                       use_guide="direct", mm_vision_tower=str(tower))
    ids = np.full((1, 10), 5)
    ids[0, 2] = VIDEO
    params = jax.jit(lambda r: JModel(config=cfg).init(r, jnp.asarray(ids), jnp.zeros((1, 4, 3, 56, 56)),
                                                       guide_ids=jnp.ones((1, 16), jnp.int32)))(
        jax.random.PRNGKey(4))["params"]
    export_hf_checkpoint(jax.device_get(params), cfg, str(ckpt), dtype="float32")
    return str(ckpt)


@pytest.fixture(scope="module")
def videos():
    rng = np.random.default_rng(26)
    return {"t64": rng.standard_normal((64, 3, 56, 56)).astype(np.float32),
            "t60": rng.standard_normal((60, 3, 56, 56)).astype(np.float32)}


@pytest.fixture(scope="module")
def guide_ids():
    return np.random.default_rng(126).integers(1, 10, (1, 16))


@pytest.fixture(scope="module")
def jax_answer(exported, videos, guide_ids):
    import hicom_tpu
    from hicom_tpu.api import HICom as JHICom

    jhc, _, tok = hicom_tpu.model_init(exported, dtype="float32", cache_len=256)
    calls = []
    real = JHICom.encode_long_video
    JHICom.encode_long_video = lambda self, *a, **k: calls.append(1) or real(self, *a, **k)
    try:
        text = hicom_tpu.mm_infer(videos["t64"], QUESTION, jhc, tok, modal="video", guide_ids=guide_ids,
                                  max_new_tokens=8)
    finally:
        JHICom.encode_long_video = real
    assert calls == [1]  # JAX took its sequence-parallel route
    return text


@pytest.fixture(scope="module")
def port(exported, videos, guide_ids, tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_api")
    cases = {"auto": (videos["t64"], "auto"), "off": (videos["t64"], "0"), "indivisible": (videos["t60"], "auto")}
    torch.save(dict(cases=cases, question=QUESTION, guide_ids=guide_ids), root / "payload.pt")
    R.spawn(R.seq_api_worker, WORLD, exported, str(root / "payload.pt"), str(root / "out"))
    return [R.load(root / f"out.{r}") for r in range(WORLD)]


def test_routed_answer_equals_jax_and_one_process(exported, videos, guide_ids, jax_answer, port):
    from transformers import AutoTokenizer

    import hicom_tpu_torch

    thc = hicom_tpu_torch.load_model(exported, dtype="float32", cache_len=256, device="cpu")
    one = hicom_tpu_torch.mm_infer(videos["t64"], QUESTION, thc, AutoTokenizer.from_pretrained(exported),
                                   modal="video", guide_ids=guide_ids, max_new_tokens=8)
    assert jax_answer and one == jax_answer
    for res in port:
        assert res["no_jax"]
        assert res["auto"] == (jax_answer, 1)


@pytest.mark.parametrize("case", ["off", "indivisible"])
def test_single_pass_when_off_or_indivisible(port, case):
    for res in port:
        text, routed = res[case]
        assert routed == 0 and text
        assert text == port[0][case][0]
