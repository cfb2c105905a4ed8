"""The port's CLIP towers against the JAX package's: the vision tower, the
guide text encoder, HICom on a CLIP tower with the direct guide, the tower
configs of a CLIP ``config.json``, and CLIP checkpoints across the packages.

float32 on both sides through other summation orders: outputs are held to
1e-5 relative, with an absolute floor of 1e-5 of the largest magnitude for
elements near zero; greedy ids exactly (random-weight logits are separated by
far more than the ~1e-6 the packages differ by).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models import clip as jclip
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models import clip as tclip
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.weights import state_dict_from_jax

VIDEO = -201
VIS = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4, image_size=56,
           patch_size=14, projection_dim=48)
TXT = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4, vocab_size=99,
           max_position_embeddings=16, projection_dim=48, eos_token_id=98)


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("with_projection", [True, False])
def test_clip_vision_tower_matches_jax(with_projection):
    pixels = np.random.default_rng(0).uniform(-1, 1, (2, 3, 56, 56)).astype(np.float32)
    jt = jclip.ClipVisionTower(config=jclip.ClipVisionConfig(**VIS), select_layer=-2,
                               with_projection=with_projection)
    params = jax.device_get(jt.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"])
    ref_feat, ref_emb = jt.apply({"params": params}, jnp.asarray(pixels))
    tt = tclip.ClipVisionTower(tcfg.ClipVisionConfig(**VIS), -2, with_projection)
    tt.load_state_dict(_sub(state_dict_from_jax({"vision_tower": params}), "model.vision_tower.vision_tower."),
                       strict=True)
    with torch.no_grad():
        feat, emb = tt(torch.from_numpy(pixels))
    _close(feat, ref_feat)  # hidden_states[-2] without CLS, (n, 4, 4, 64)
    if with_projection:
        _close(emb, ref_emb)  # visual_projection(post_layernorm(last)[:, 1:])
    else:
        assert emb is None and ref_emb is None


@pytest.mark.parametrize("masked", [False, True])
def test_clip_text_encoder_matches_jax(masked):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 97, (2, 12))
    ids[0, 7] = ids[1, 11] = TXT["eos_token_id"]  # pooled at the first eos of each row
    mask = np.ones((2, 12), np.int32)
    mask[0, 9:] = 0
    jt = jclip.ClipTextEncoder(config=jclip.ClipTextConfig(**TXT))
    params = jax.device_get(jt.init(jax.random.PRNGKey(1), jnp.asarray(ids))["params"])
    ref_pooled, ref_tokens = jt.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask) if masked else None)
    tt = tclip.ClipTextEncoder(tcfg.ClipTextConfig(**TXT))
    tt.load_state_dict(_sub(state_dict_from_jax({"guide_encoder": params}), "model.vision_tower.guide_encoder."),
                       strict=True)
    with torch.no_grad():
        pooled, tokens = tt(torch.from_numpy(ids), torch.from_numpy(mask) if masked else None)
    _close(pooled, ref_pooled)
    _close(tokens, ref_tokens)


def _clip_configs(**kw):
    """tests/test_clip_parity.py's HICom on a CLIP tower with the direct guide."""
    out = []
    for mod, clip in ((jcfg, jclip), (tcfg, tcfg)):
        args = dict(text_config=mod.tiny_test_config().text_config, vision_config=clip.ClipVisionConfig(**VIS),
                    guide_text_config=clip.ClipTextConfig(**TXT), mm_vision_tower="clip-vit-large-patch14-336",
                    mm_projector_type="local43_global8", use_guide="direct",
                    projector_qk_dim=VIS["projection_dim"], dtype="float32")
        out.append(mod.HIComConfig(**{**args, **kw}))
    return out


def _clip_pair(seed=0, **kw):
    cj, ct = _clip_configs(**kw)
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((1, 4, 3, 56, 56)).astype(np.float32)
    ids = rng.integers(5, cj.text_config.vocab_size, (1, 10))
    ids[0, 2] = VIDEO
    gids = rng.integers(0, TXT["vocab_size"], (1, 12))
    jm = JModel(config=cj)
    init = jax.jit(lambda key, i, f, g: jm.init(key, i, f, guide_ids=g, modal="video"))
    params = jax.device_get(init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(frames),
                                 jnp.asarray(gids))["params"])
    tm = TModel(ct)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm.eval(), ids, frames, gids


def test_hicom_on_a_clip_tower_matches_jax():
    jm, params, tm, ids, frames, gids = _clip_pair()
    ref, _, _ = jax.jit(lambda p, i, f, g: jm.apply({"params": p}, i, f, guide_ids=g, modal="video"))(
        params, jnp.asarray(ids), jnp.asarray(frames), jnp.asarray(gids))
    with torch.no_grad():
        got, _, _ = tm.one_shot_forward(torch.from_numpy(ids), torch.from_numpy(frames),
                                        guide_ids=torch.from_numpy(gids), modal="video")
    # local43 at t = 4: 1 x 2 x 2 = 4 tokens, and 8 global
    assert got.shape[1] == 10 - 1 + 4 + 8
    _close(got, ref)


def _write_clip_tower(path):
    path.mkdir()
    with open(path / "config.json", "w") as f:
        vision = {k: v for k, v in VIS.items() if k != "projection_dim"} | {"hidden_act": "quick_gelu"}
        text = {k: v for k, v in TXT.items() if k != "projection_dim"} | {"bos_token_id": 97}
        json.dump({"model_type": "clip", "projection_dim": VIS["projection_dim"], "vision_config": vision,
                   "text_config": text}, f)
    return str(path)


def test_tower_configs_of_a_clip_config_json(tmp_path):
    from hicom_tpu.api import _tower_configs

    tower = _write_clip_tower(tmp_path / "clip-vit-large-patch14-336")
    for got, ref in zip(tcfg.tower_configs(tower), _tower_configs(tower)):
        assert {f.name: getattr(got, f.name) for f in dataclasses.fields(ref)} == dataclasses.asdict(ref)
    vision, text = tcfg.tower_configs("openai/clip-vit-large-patch14-336")  # the published widths, by name
    assert (vision.num_hidden_layers, vision.hidden_size, vision.num_patches + 1, vision.projection_dim) == (
        24, 1024, 577, 768)
    assert (text.num_hidden_layers, text.hidden_size, text.max_position_embeddings, text.eos_token_id) == (
        12, 768, 77, 49407)
    assert tcfg.projector_qk_dim(vision) == 768 and tcfg.projector_qk_dim(tcfg.SiglipVisionConfig()) is None


def test_clip_checkpoints_cross_the_packages(tmp_path):
    """A CLIP checkpoint exported by the JAX package, loaded by the port's
    ``load_model``, gives JAX's greedy ids; the port's export of the same
    model, loaded by the JAX package, gives them too."""
    import hicom_tpu_torch
    from hicom_tpu.api import load_model as j_load
    from hicom_tpu.weights import export_hf_checkpoint as j_export
    from hicom_tpu_torch.weights import export_hf_checkpoint as t_export

    tower = _write_clip_tower(tmp_path / "clip-vit-large-patch14-336")
    jm, params, tm, ids, frames, gids = _clip_pair(seed=3, mm_vision_tower=tower)
    j_export(params, jm.config, str(tmp_path / "jax_export"), dtype="float32")
    t_export(tm.state_dict(), tm.hicom_config, str(tmp_path / "port_export"), dtype="float32")
    kw = dict(modal="video", max_new_tokens=6)
    ref = j_load(str(tmp_path / "jax_export"), dtype="float32", cache_len=128).generate(
        ids, frames, gids, **kw)
    thc = hicom_tpu_torch.load_model(str(tmp_path / "jax_export"), dtype="float32", cache_len=128, device="cpu")
    assert thc.config.qk_dim == VIS["projection_dim"]
    np.testing.assert_array_equal(thc.generate(ids, frames, gids, **kw), ref)
    back = j_load(str(tmp_path / "port_export"), dtype="float32", cache_len=128)
    np.testing.assert_array_equal(back.generate(ids, frames, gids, **kw), ref)
