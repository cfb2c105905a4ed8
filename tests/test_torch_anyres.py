"""The port's anyres images against the JAX package's: merge geometry, the
merge, the anyres encoders, ``mm_infer`` with ``image_size``, the anyres train
step and the dataset's batches grouped by merge plan.

Plans and merges are compared exactly (host ints; the same float32 ops in the
same order). Model outputs are float32 on both sides through other
summation orders: they are held to 1e-5 relative, with an absolute floor of
1e-5 of the largest magnitude for elements near zero.
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hicom_tpu import config as jcfg
from hicom_tpu.models import anyres as janyres
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu.ops import resize as jresize
from hicom_tpu.train import dataset as jds
from hicom_tpu.train import optimizer as jopt
from hicom_tpu.train import train_step as jstep
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models import anyres as tanyres
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.ops import resize as tresize
from hicom_tpu_torch.train import dataset as tds
from hicom_tpu_torch.train import optimizer as topt
from hicom_tpu_torch.train import train_step as tstep
from hicom_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_data import WordTokenizer

IMAGE, IGNORE = -200, -100
# literal pinpoints: the "(1x1),...,(NxN)" range syntax asserts a standard ViT size, which a 56 px tower is not
PINS = "[[56, 56], [56, 112], [112, 56], [112, 112], [56, 168], [168, 56], [112, 168], [168, 112], [168, 168]]"
SIZES = [(168, 168), (170, 90), (60, 150)]  # a 3x3 grid (downscaled under anyres_max_4), a wide and a tall image


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _plan_cfg(merge, aspect, pins=PINS):
    return types.SimpleNamespace(mm_patch_merge_type=merge, image_aspect_ratio=aspect, image_grid_pinpoints=pins)


@pytest.mark.parametrize("size,grid,unpad,down,tokens", [
    ((1920, 1080), (3, 5), (3, 78, 0, 135), (60, 108), 7270),
    ((1024, 1024), (3, 3), (0, 81, 0, 81), None, 7372)])
def test_so400m_plans_of_the_anyres_configuration(size, grid, unpad, down, tokens):
    # mlp2x_gelu_anyres.sh: anyres_max_9 over (1x1),...,(6x6) at 384 px, 27 patches a side
    cfg = _plan_cfg("spatial_unpad", "anyres_max_9", "(1x1),...,(6x6)")
    ref = janyres.make_anyres_plan(size, cfg, 384, hw=27)
    got = tanyres.make_anyres_plan(size, cfg, 384, hw=27)
    assert tuple(got) == tuple(ref)
    assert (got.nh, got.nw, got.unpad, got.down) == grid + (unpad, down)
    assert got.token_count(has_newline=True) == ref.token_count(has_newline=True) == tokens


@pytest.mark.parametrize("merge", ["spatial", "spatial_maxpool2x2", "spatial_unpad", "spatial_unpad_nobase", "flat"])
def test_make_anyres_plan_matches_jax(merge):
    for aspect in ("anyres", "anyres_max_4"):
        for size in SIZES + [(300, 40), (41, 41)]:
            ref = janyres.make_anyres_plan(size, _plan_cfg(merge, aspect), 56, hw=4)
            got = tanyres.make_anyres_plan(size, _plan_cfg(merge, aspect), 56, hw=4)
            assert (got is None) == (ref is None) == (merge == "flat")
            if ref is not None:
                assert tuple(got) == tuple(ref), (aspect, size)
                assert got.merged_hw() == ref.merged_hw()
                for nl in (False, True):
                    assert got.token_count(nl) == ref.token_count(nl)
    # the downscale: a 3x3 grid of 4x4 patches exceeds anyres_max_4's 64 units
    assert tanyres.make_anyres_plan((168, 168), _plan_cfg("spatial_unpad", "anyres_max_4"), 56, hw=4).down == (8, 8)


def test_unpad_bounds_match_jax():
    for grid in [(8, 8), (12, 8), (4, 12), (81, 135)]:
        for size in [(100, 50), (50, 100), (300, 300), (640, 480), (1920, 1080)]:
            assert tanyres.unpad_bounds(grid, size) == janyres.unpad_bounds(grid, size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool2d_bit_equal_to_jax(dtype):
    x = np.random.default_rng(0).standard_normal((2, 7, 9, 5)).astype(np.float32)
    x[0, 0, 0] = -np.inf  # the window's identity is -inf
    for arr in (x[0], x):  # (h, w, d) as JAX takes it, and with a batch axis
        ref = np.stack([np.asarray(jresize.max_pool2d(jnp.asarray(a, dtype), 2).astype(jnp.float32))
                        for a in arr.reshape(-1, 7, 9, 5)])
        got = tresize.max_pool2d(torch.from_numpy(arr).to(getattr(torch, dtype)), 2).float().numpy()
        np.testing.assert_array_equal(got.reshape(ref.shape), ref)


@pytest.mark.parametrize("merge,aspect", [("spatial", "anyres"), ("spatial_maxpool2x2", "anyres"),
                                          ("spatial_unpad", "anyres"), ("spatial_unpad", "anyres_max_4"),
                                          ("spatial_unpad_nobase", "anyres_max_4")])
def test_apply_anyres_plan_matches_jax(merge, aspect):
    rng = np.random.default_rng(1)
    for size in SIZES:
        plan = janyres.make_anyres_plan(size, _plan_cfg(merge, aspect), 56, hw=4)
        feats = rng.standard_normal((2, 1 + plan.nh * plan.nw, 4, 4, 6)).astype(np.float32)
        for dtype in ("float32", "bfloat16"):
            got = tanyres.apply_anyres_plan(torch.from_numpy(feats).to(getattr(torch, dtype)), plan)
            for row in range(2):  # a batch of rows sharing the plan against JAX's per-sample merge
                ref = janyres.apply_anyres_plan(jnp.asarray(feats[row], dtype), plan)
                for part in ("base", "patch"):
                    if ref[part] is None:
                        assert got[part] is None
                        continue
                    # the same ops in the same order, in the input's dtype: bit-equal
                    np.testing.assert_array_equal(got[part][row].float().numpy(),
                                                  np.asarray(ref[part].astype(jnp.float32)), err_msg=f"{part} {dtype}")


def _anyres_configs(projector, **kw):
    kw = dict(image_aspect_ratio="anyres_max_4", mm_patch_merge_type="spatial_unpad", image_grid_pinpoints=PINS,
              mm_projector_type=projector, **kw)
    if projector != "mlp2x_gelu":
        kw["use_guide"] = "direct"
    return jcfg.tiny_test_config(**kw), tcfg.tiny_test_config(**kw)


@functools.lru_cache(maxsize=None)
def _models(projector, seed=0):
    """A JAX model with its parameters and the port's with the same weights
    (the parameters do not depend on the plan the init runs)."""
    cj, ct = _anyres_configs(projector)
    plan = janyres.make_anyres_plan((112, 112), cj, 56)
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, (1, 10))
    ids[:, 1] = IMAGE
    crops = rng.standard_normal((1, 1 + plan.nh * plan.nw, 3, 56, 56)).astype(np.float32)
    gids = jnp.asarray(rng.integers(1, 250, (1, 16))) if cj.guide_enabled() else None
    jm = JModel(config=cj)
    init = jax.jit(lambda key, i, f, g: jm.init(key, i, f, modal="image", anyres_plan=plan, guide_ids=g))
    params = jax.device_get(init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(crops), gids)["params"])
    return jm, params, state_dict_from_jax(params), ct


def _anyres_pair(projector, size=(168, 168), b=1, seed=0):
    """The two models (the port's fresh, from the cached weights) and inputs of
    ``b`` rows for an image of ``size``."""
    jm, params, sd, ct = _models(projector, seed)
    plan = janyres.make_anyres_plan(size, jm.config, 56)
    rng = np.random.default_rng(seed + 1)
    ids = rng.integers(3, 500, (b, 10))
    ids[:, 1] = IMAGE
    crops = rng.standard_normal((b, 1 + plan.nh * plan.nw, 3, 56, 56)).astype(np.float32)
    gids = rng.integers(1, 250, (b, 16)) if jm.config.guide_enabled() else None
    tm = TModel(ct)
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm.eval(), plan, ids, crops, gids


@pytest.mark.parametrize("projector", ["mlp2x_gelu", "local43_global32"])
@pytest.mark.parametrize("size", SIZES)
def test_encode_visual_anyres_matches_jax(projector, size):
    # local43_global32 + direct guide is the HICom dict path: the base and the patch grid
    jm, params, tm, plan, _, crops, gids = _anyres_pair(projector, size)
    jge = tge = None
    if gids is not None:
        jge = jm.apply({"params": params}, jnp.asarray(gids), method=JModel.encode_guide)[0]
        tge = tm.encode_guide(torch.from_numpy(gids))[0]
    ref = jax.jit(lambda p, c, g: jm.apply({"params": p}, c, size, g, method=JModel.encode_visual_anyres))(
        params, jnp.asarray(crops[0]), jge)
    with torch.no_grad():
        got = tm.encode_visual_anyres(torch.from_numpy(crops[0]), size, tge)
        by_plan = tm.encode_visual_anyres_plan(torch.from_numpy(crops[0]), tanyres.make_anyres_plan(
            size, tm.hicom_config, 56), tge)
    _close(got, ref)
    torch.testing.assert_close(by_plan, got, rtol=0, atol=0)
    if projector == "mlp2x_gelu":
        assert got.shape[0] == plan.token_count(has_newline=True)


@pytest.mark.parametrize("projector", ["mlp2x_gelu", "local43_global32"])
def test_mm_infer_with_image_size_matches_jax(tmp_path, projector):
    """A multi-crop anyres image from a PNG through each package's
    ``model_init`` processor and ``mm_infer(..., image_size=...)``, on one
    checkpoint written by the JAX package's export: the same string."""
    from transformers import AutoTokenizer

    import hicom_tpu
    import hicom_tpu_torch
    from hicom_tpu.weights import export_hf_checkpoint
    from hicom_tpu_torch.api import model_init
    from tests.test_torch_api import WORDS, _word_tokenizer

    tower, ckpt = tmp_path / "siglip-so400m-patch14-384", tmp_path / "ckpt"
    tower.mkdir()
    ckpt.mkdir()
    cj, _ = _anyres_configs(projector)
    vis, txt = cj.vision_config, cj.guide_text_config
    with open(tower / "config.json", "w") as f:
        json.dump({"model_type": "siglip",
                   "vision_config": {k: getattr(vis, k) for k in ("hidden_size", "intermediate_size",
                                                                  "num_hidden_layers", "num_attention_heads",
                                                                  "image_size", "patch_size")},
                   "text_config": {k: getattr(txt, k) for k in ("hidden_size", "intermediate_size",
                                                                "num_hidden_layers", "num_attention_heads",
                                                                "vocab_size", "max_position_embeddings",
                                                                "projection_size")}}, f)
    n_vocab = _word_tokenizer(ckpt, WORDS, {
        "chat_template": "{% for m in messages %}{{ m['content'] }}\n{% endfor %}"
                         "{% if add_generation_prompt %}ASSISTANT:{% endif %}"})
    cfg = cj.replace(text_config=jcfg.Qwen2Config(**{**cj.text_config.__dict__, "vocab_size": n_vocab}),
                     mm_vision_tower=str(tower))
    plan = janyres.make_anyres_plan((170, 90), cfg, 56)
    rng = np.random.default_rng(5)
    ids = rng.integers(3, n_vocab, (1, 10))
    ids[0, 2] = IMAGE
    gids = rng.integers(1, 250, (1, 16))
    init = jax.jit(lambda key, i, f, g: JModel(config=cfg).init(key, i, f, modal="image", anyres_plan=plan,
                                                               guide_ids=g))
    params = init(jax.random.PRNGKey(5), jnp.asarray(ids),
                  jnp.asarray(rng.standard_normal((1, 1 + plan.nh * plan.nw, 3, 56, 56)), jnp.float32),
                  jnp.asarray(gids) if cfg.guide_enabled() else None)["params"]
    export_hf_checkpoint(jax.device_get(params), cfg, str(ckpt), dtype="float32")
    png = tmp_path / "wide.png"
    Image.fromarray(rng.integers(0, 255, (90, 170, 3), dtype=np.uint8)).save(png)

    kw = dict(modal="image", max_new_tokens=8, guide_ids=gids)
    jhc, jproc, tok = hicom_tpu.model_init(str(ckpt), dtype="float32", cache_len=256)
    jcrops, jsizes = jproc["image"](str(png))
    ref = hicom_tpu.mm_infer(jcrops, "what is in the video ?", jhc, tok, image_size=jsizes[0], **kw)
    thc, tproc, ttok = model_init(str(ckpt), dtype="float32", cache_len=256, device="cpu")
    tcrops, tsizes = tproc["image"](str(png))
    np.testing.assert_array_equal(tcrops, jcrops)
    assert tsizes == jsizes and tcrops.shape[0] == 1 + plan.nh * plan.nw > 1
    got = hicom_tpu_torch.mm_infer(tcrops, "what is in the video ?", thc, AutoTokenizer.from_pretrained(str(ckpt)),
                                   image_size=tsizes[0], **kw)
    assert ref and got == ref  # non-empty: the seeded model emits words before eos


def _anyres_batch(b, crops, ids):
    mask = np.ones(ids.shape, bool)
    mask[1:, 8:] = False  # the second row right-padded
    ids = np.where(mask, ids, 0)
    labels = np.where(mask, ids, IGNORE)
    labels[:, :3] = IGNORE
    return dict(input_ids=ids, attention_mask=mask, labels=labels, frames=crops)


def test_anyres_loss_and_gradients_match_jax():
    """The anyres forward's loss and its gradients in the projector and
    ``image_newline``, every parameter trainable on both sides."""
    jm, params, tm, plan, ids, crops, _ = _anyres_pair("mlp2x_gelu", (170, 90), b=2)
    batch = _anyres_batch(2, crops, ids)
    loss_fn = jstep.make_loss_fn(jm, modal="image", anyres_plan=plan)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tm.train()
    loss, _ = tstep.make_loss_fn(tm, modal="image", anyres_plan=plan)({k: torch.from_numpy(v)
                                                                         for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref = state_dict_from_jax(jax.device_get({"mm_projector": jgrads["mm_projector"],
                                              "image_newline": jgrads["image_newline"]}))
    named = dict(tm.named_parameters())
    assert len(ref) == 5  # two linears' weights and biases, and the newline
    for name, g in ref.items():
        assert float(g.abs().max()) > 0, name
        _close(named[name].grad, g)


def test_anyres_train_steps_match_jax():
    """Two projector steps (the pretrain stage of mlp2x_gelu_anyres.sh) under
    one plan: losses, gradient norms and the updated projector."""
    jm, params, tm, plan, ids, crops, _ = _anyres_pair("mlp2x_gelu", (170, 90), b=2)
    batch = _anyres_batch(2, crops, ids)
    opt_kw = dict(learning_rate=1e-3, total_steps=4, warmup_ratio=0.0, eps=1e-6)
    tx = jopt.build_optimizer(params, tunable_parts="mm_projector", weight_decay=0.05, **opt_kw)
    jstate = jstep.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step_j = jax.jit(jstep.make_train_step(jm, tx, modal="image", anyres_plan=plan, tunable_parts="mm_projector"))
    opt = topt.build_optimizer(tm, tunable_parts="mm_projector", weight_decay=0.05, **opt_kw)
    state = tstep.create_train_state(tm, opt, device="cpu")
    step_t = tstep.make_train_step(modal="image", anyres_plan=plan)
    for i in range(2):
        jstate, jm_ = step_j(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, tm_ = step_t(state, batch)
        assert int(tm_["target_tokens"]) == int(jm_["target_tokens"])
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-5, err_msg=f"loss {i}")
        np.testing.assert_allclose(float(tm_["grad_norm"]), float(jm_["grad_norm"]), rtol=1e-4, err_msg=f"norm {i}")
    ref = state_dict_from_jax(jax.device_get({"mm_projector": jstate.params["mm_projector"]}))
    got = state.params()
    for name, t in ref.items():
        # a hundredth of one step: the bound test_torch_train.py sets for Adam's near-zero gradients
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
        assert not torch.equal(got[name], state_dict_from_jax({"mm_projector": params["mm_projector"]})[name])


def test_dataset_groups_batches_by_plan_as_jax(tmp_path):
    """Rows of two image geometries (two plans) and a multi-image row: the
    same plans, the same batches in the same order, each with one plan."""
    from hicom_tpu.data.processor import SiglipImagePreprocessor as JProc
    from hicom_tpu_torch.data.processor import SiglipImagePreprocessor as TProc

    rng = np.random.default_rng(0)
    rows = []
    for i, (w, h) in enumerate([(160, 60), (100, 100), (160, 60), (100, 100), (160, 60), (100, 100)]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(tmp_path / f"{i}.png")
        rows.append({"image": f"{i}.png", "conversations": [
            {"from": "human", "value": "<image> describe the picture"}, {"from": "gpt", "value": "a red cat"}]})
    (tmp_path / "data.json").write_text(json.dumps(rows))
    kw = dict(data_path=[str(tmp_path / "data.json")], data_folder=str(tmp_path), image_aspect_ratio="anyres_max_4",
              image_grid_pinpoints=PINS, mm_patch_merge_type="spatial_unpad", image_size=56, patch_size=14)
    jdset = jds.SupervisedDataset(WordTokenizer(), jds.DataArguments(**kw), JProc(size=(56, 56)))
    tdset = tds.SupervisedDataset(WordTokenizer(), tds.DataArguments(**kw), TProc(size=(56, 56)))
    assert tdset._anyres_train
    plans = [tdset.anyres_plan_of(i) for i in range(len(rows))]
    assert [tuple(p) for p in plans] == [tuple(jdset.anyres_plan_of(i)) for i in range(len(rows))]
    assert len(set(plans)) == 2
    for seed in (0, 1):
        ref = list(jds.iter_batches(jdset, jds.Collator(WordTokenizer(), jdset.args), batch_size=2, seed=seed))
        got = list(tds.iter_batches(tdset, tds.Collator(WordTokenizer(), tdset.args), batch_size=2, seed=seed))
        assert len(got) == len(ref) == 2  # one full batch of each plan; the partial ones drop
        for g, r in zip(got, ref):
            assert tuple(g["anyres_plan"]) == tuple(r["anyres_plan"]) and g["multi_image"] is r["multi_image"] is False
            for key in ("input_ids", "labels", "attention_mask", "frames"):
                np.testing.assert_array_equal(g[key], r[key], err_msg=key)
