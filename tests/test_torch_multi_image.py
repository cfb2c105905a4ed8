"""The port's multi-image prompts and mean-pool projector against the JAX
package's: the K-sentinel splice, the multi-image forward and loss, the
mean-pool video and image paths, the collator's multi-image batches and two
stage-2 steps on rows of 2 images.

The splice and the collator are compared exactly. Model outputs are float32
on both sides through other summation orders: 1e-5 relative, with an
absolute floor of 1e-5 of the largest magnitude for elements near zero.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hicom_tpu import config as jcfg
from hicom_tpu.models import splice as jsplice
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu.train import dataset as jds
from hicom_tpu.train import optimizer as jopt
from hicom_tpu.train import train_step as jstep
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models import splice as tsplice
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.train import dataset as tds
from hicom_tpu_torch.train import optimizer as topt
from hicom_tpu_torch.train import train_step as tstep
from hicom_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_data import WordTokenizer

IMAGE, VIDEO, IGNORE = -200, -201, -100


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("case", ["fewer", "exactly_k", "more"])
def test_multi_sentinel_splice_matches_jax(case):
    """Rows of 1, 2 or 3 sentinels against K = 2 images of V = 3 tokens, with
    a right-padded row and labels."""
    rng = np.random.default_rng({"fewer": 0, "exactly_k": 1, "more": 2}[case])
    b, L, K, V, D = 3, 12, 2, 3, 5
    ids = rng.integers(3, 100, (b, L))
    n_sent = {"fewer": 1, "exactly_k": 2, "more": 3}[case]
    for r in range(b):
        ids[r, sorted(rng.choice(np.arange(1, 9), n_sent if r != 1 else min(n_sent, 2), replace=False))] = IMAGE
    mask = np.ones((b, L), bool)
    mask[2, 10:] = False
    labels = np.where(mask, ids, IGNORE)
    labels[:, :2] = IGNORE
    text = rng.standard_normal((b, L, D)).astype(np.float32)
    vis = rng.standard_normal((b, K, V, D)).astype(np.float32)
    ref = jsplice.splice_visual_embeds_multi(jnp.asarray(ids), jnp.asarray(text), jnp.asarray(vis),
                                             jnp.asarray(mask), jnp.asarray(labels))
    got = tsplice.splice_visual_embeds_multi(torch.from_numpy(ids), torch.from_numpy(text), torch.from_numpy(vis),
                                             torch.from_numpy(mask), torch.from_numpy(labels))
    assert got.embeds.shape == (b, L + K * (V - 1), D)
    for name in ("embeds", "attention_mask", "labels", "positions"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)


def _configs(**kw):
    return jcfg.tiny_test_config(**kw), tcfg.tiny_test_config(**kw)


def _multi_batch(cfg, seed=0):
    """b = 2 rows of K = 2 images: row 0 with two sentinels, row 1 with one
    (its second image is padding the splice leaves out) and right-padded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.text_config.vocab_size, (2, 14))
    ids[0, [2, 7]] = IMAGE
    ids[1, 3] = IMAGE
    mask = np.ones((2, 14), bool)
    mask[1, 11:] = False
    ids[1, 11:] = 0
    labels = np.where(mask, ids, IGNORE)
    labels[:, :4] = IGNORE
    frames = rng.standard_normal((2, 2, 3, 56, 56)).astype(np.float32)
    frames[1, 1] = 0.0
    batch = dict(input_ids=ids, attention_mask=mask, labels=labels, frames=frames)
    if cfg.guide_enabled():
        batch["guide_ids"] = rng.integers(1, cfg.guide_text_config.vocab_size, (2, 16))
    return batch


def _pair(cj, ct, batch, **init_kw):
    jm = JModel(config=cj)
    g = jnp.asarray(batch["guide_ids"]) if "guide_ids" in batch else None
    init = jax.jit(lambda key, i, f, g: jm.init(key, i, f, guide_ids=g, **init_kw))
    params = jax.device_get(init(jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]),
                                 jnp.asarray(batch["frames"]), g)["params"])
    tm = TModel(ct)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("projector", ["local43_global32", "mlp2x_gelu"])
def test_multi_image_forward_and_loss_match_jax(projector):
    cj, ct = _configs(mm_projector_type=projector, **({"use_guide": "direct"} if projector != "mlp2x_gelu" else {}))
    batch = _multi_batch(cj)
    jm, params, tm = _pair(cj, ct, batch, modal="image", multi_image=True)
    loss_fn = jstep.make_loss_fn(jm, modal="image", multi_image=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_logits, ref_labels, ref_mask = jax.jit(lambda p, b: jm.apply(
        {"params": p}, b["input_ids"], b["frames"], attention_mask=b["attention_mask"], labels=b["labels"],
        guide_ids=b.get("guide_ids"), modal="image", multi_image=True))(params, jbatch)
    ref_loss, _ = jax.jit(loss_fn)(params, jbatch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, labels, mask = tm.one_shot_forward(
            tbatch["input_ids"], tbatch["frames"], attention_mask=tbatch["attention_mask"], labels=tbatch["labels"],
            guide_ids=tbatch.get("guide_ids"), modal="image", multi_image=True)
        loss, _ = tstep.make_loss_fn(tm, modal="image", multi_image=True)(tbatch)
    V = tm.visual_token_count(1, "image")
    assert logits.shape[1] == 14 + 2 * (V - 1)
    _close(logits, ref_logits)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)


@pytest.mark.parametrize("modal", ["video", "image"])
@pytest.mark.parametrize("projector", ["mlp2x_gelu", "linear"])
def test_mean_pool_path_matches_jax(modal, projector):
    """``_mean_pool_project``: the MLP per token, for video a 2x2 trilinear
    downsample; the newline of a spatial merge for the image."""
    kw = dict(mm_projector_type=projector)
    if modal == "image":
        kw.update(mm_patch_merge_type="spatial", image_aspect_ratio="anyres", mm_newline_position="one_token")
    cj, ct = _configs(**kw)
    rng = np.random.default_rng(3)
    t = 4 if modal == "video" else 1
    frames = rng.standard_normal((2, t, 3, 56, 56)).astype(np.float32)
    ids = rng.integers(3, 500, (2, 10))
    ids[:, 2] = VIDEO if modal == "video" else IMAGE
    jm, params, tm = _pair(cj, ct, dict(input_ids=ids, frames=frames), modal=modal)
    ref = jax.jit(lambda p, f: jm.apply({"params": p}, f, None, modal, method=JModel.encode_visual))(
        params, jnp.asarray(frames))
    with torch.no_grad():
        got = tm.encode_visual(torch.from_numpy(frames), None, modal)
    # video: 4 x ceil(4/2)^2 = 16 tokens; image: 16 and the newline
    assert got.shape[1] == tm.visual_token_count(t, modal) == (16 if modal == "video" else 17)
    _close(got, ref)


@pytest.mark.parametrize("batch_size", [2, 3])
def test_collator_multi_image_batches_match_jax(tmp_path, batch_size):
    """Rows of two images (K sentinels), of one and of three: the same
    ``(b, K, 3, H, W)`` frames, ids, labels and flags in the same order, in
    pairs and in ``iter_batches`` of ``batch_size`` rows."""
    from hicom_tpu.data.processor import SiglipImagePreprocessor as JProc
    from hicom_tpu_torch.data.processor import SiglipImagePreprocessor as TProc

    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (30 + 4 * i, 40, 3), dtype=np.uint8)).save(tmp_path / f"{i}.png")
    convo = [{"from": "human", "value": "<image> <image> compare the pictures"}, {"from": "gpt", "value": "a cat"}]
    rows = [{"image": ["0.png", "1.png"], "conversations": convo},
            {"image": "2.png", "conversations": [dict(convo[0], value="<image> one picture"), convo[1]]},
            {"image": ["1.png", "2.png", "3.png"], "conversations": convo},
            {"image": "3.png", "conversations": [dict(convo[0], value="<image> what"), convo[1]]}]
    (tmp_path / "d.json").write_text(json.dumps(rows))
    kw = dict(data_path=[str(tmp_path / "d.json")], data_folder=str(tmp_path), image_size=56)
    jdset = jds.SupervisedDataset(WordTokenizer(), jds.DataArguments(**kw), JProc(size=(56, 56)))
    tdset = tds.SupervisedDataset(WordTokenizer(), tds.DataArguments(**kw), TProc(size=(56, 56)))
    jcol = jds.Collator(WordTokenizer(), jdset.args)
    tcol = tds.Collator(WordTokenizer(), tdset.args)
    for idx in ([0, 2], [1, 3], [0, 1]):
        ref, got = jcol([jdset[i] for i in idx]), tcol([tdset[i] for i in idx])
        assert set(got) == set(ref)
        assert got["multi_image"] == ref["multi_image"] == (idx != [1, 3])
        for key in ("input_ids", "labels", "attention_mask", "frames"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    got = list(tds.iter_batches(tdset, tcol, batch_size=batch_size, seed=1))
    ref = list(jds.iter_batches(jdset, jcol, batch_size=batch_size, seed=1))
    assert len(got) == len(ref) == 4 // batch_size  # the last partial batch is dropped
    for g, r in zip(got, ref):
        assert g["multi_image"] == r["multi_image"]
        for key in ("input_ids", "labels", "frames"):
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)


def test_two_multi_image_stage2_steps_match_jax():
    """Stage 2 (projector and guide injectors trained) with ``multi_image``:
    two steps' losses and gradient norms, and the trained parameters after."""
    parts, use_guide = "mm_projector", "direct"
    cj, ct = _configs(use_guide=use_guide)
    batch = _multi_batch(cj, seed=1)
    jm, params, tm = _pair(cj, ct, batch, modal="image", multi_image=True)
    opt_kw = dict(learning_rate=2e-3, guide_injector_lr=1e-3, total_steps=4, eps=1e-6, warmup_ratio=0.25)
    tx = jopt.build_optimizer(params, tunable_parts=parts, use_guide=use_guide, weight_decay=0.05, **opt_kw)
    jstate = jstep.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step_j = jax.jit(jstep.make_train_step(jm, tx, modal="image", multi_image=True, tunable_parts=parts,
                                           use_guide=use_guide))
    opt = topt.build_optimizer(tm, tunable_parts=parts, use_guide=use_guide, weight_decay=0.05, **opt_kw)
    state = tstep.create_train_state(tm, opt, device="cpu")
    step_t = tstep.make_train_step(modal="image", multi_image=True)
    for i in range(2):
        jstate, jm_ = step_j(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, tm_ = step_t(state, batch)
        assert int(tm_["target_tokens"]) == int(jm_["target_tokens"])
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-5, err_msg=f"loss {i}")
        np.testing.assert_allclose(float(tm_["grad_norm"]), float(jm_["grad_norm"]), rtol=1e-4, err_msg=f"norm {i}")
    ref = state_dict_from_jax(jax.device_get(jstate.params))
    got = state.params()
    trained = {n for n, p in tm.named_parameters() if p.requires_grad}
    assert trained and all(n.startswith("model.mm_projector.") for n in trained)
    for name in trained:
        # a hundredth of one step: the bound test_torch_train.py sets for Adam's near-zero gradients
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(), rtol=1e-5,
                                   atol=0.01 * opt_kw["learning_rate"], err_msg=name)
