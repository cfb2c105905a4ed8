"""The port's training against the JAX package's, on the tiny model.

* The freeze matrix, learning-rate groups and decay labels of every parameter
  equal the JAX labels of its counterpart (matched through
  ``state_dict_from_jax``) under each stage's tunable parts.
* ``make_schedule`` equals the optax schedule of the JAX package at every count.
* Two train steps of the port equal two of JAX's ``make_train_step`` on the
  same weights and batch, in fp32, for stage 1 and stage 2: loss, grad norm
  and every parameter.
* The exported ``mm_projector.bin`` loads through the JAX package's own
  converter into the same values, and a checkpoint round trip resumes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu import weights as jweights
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu.train import optimizer as jopt
from hicom_tpu.train import train_step as jstep
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.train import checkpoints as tckpt
from hicom_tpu_torch.train import optimizer as topt
from hicom_tpu_torch.train import train_step as tstep
from hicom_tpu_torch.weights import state_dict_from_jax

VIDEO, IGNORE = -201, -100
STAGES = {  # the reference's stages as (mm_tunable_parts, use_guide), plus the remaining parts
    "stage1": ("mm_projector", None),
    "stage2": ("mm_projector", "direct"),
    "stage3": ("mm_projector,language_model,vision_model_head,guide_encoder", "direct"),
    "tower_and_scales": ("pure_vision_model,attn_scale", "direct"),
}


def _configs(use_guide, **kw):
    if use_guide:
        kw["use_guide"] = use_guide
    return jcfg.tiny_test_config(**kw), tcfg.tiny_test_config(**kw)


def _batch(cfg, seed=0):
    """b = 2, 12 ids with a <video> sentinel, the second row right-padded from
    9; the first 4 labels and the padding are ignored; 4 frames; guide ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.text_config.vocab_size, (2, 12))
    ids[:, 2] = VIDEO
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    ids[1, 9:] = 0
    labels = np.where(mask, ids, IGNORE)
    labels[:, :4] = IGNORE
    size = cfg.vision_config.image_size
    batch = dict(input_ids=ids, attention_mask=mask, labels=labels,
                 frames=rng.standard_normal((2, 4, 3, size, size)).astype(np.float32))
    if cfg.guide_enabled():
        batch["guide_ids"] = rng.integers(1, cfg.guide_text_config.vocab_size, (2, 16))
    return batch


def _pair(use_guide, **kw):
    cj, ct = _configs(use_guide, **kw)
    batch = _batch(cj)
    jm = JModel(config=cj)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]), jnp.asarray(batch["frames"]),
                     guide_ids=jnp.asarray(batch["guide_ids"]) if "guide_ids" in batch else None)["params"]
    params = jax.device_get(params)
    tm = TModel(ct)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm, batch


def _torch_to_jax_path(params):
    """{torch name: JAX path}: every JAX leaf filled with its own index goes
    through ``state_dict_from_jax``, which moves (and transposes) but never
    mixes values."""
    paths, _ = jopt.tree_paths(params)
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(leaf), i, np.float32) for i, (_, leaf) in enumerate(paths)])
    out = {}
    for name, t in state_dict_from_jax(marked).items():
        assert t.min() == t.max(), name
        out[name] = paths[int(t.flatten()[0])][0]
    return out


@pytest.mark.parametrize("clip_scale", [False, True])
def test_freeze_matrix_lr_groups_and_decay_match_jax(clip_scale):
    _, params, tm, _ = _pair("direct", use_clip_scale="local,global" if clip_scale else "")
    to_jax = _torch_to_jax_path(params)
    assert set(to_jax) == {n for n, _ in tm.named_parameters()}
    j_paths, _ = jopt.tree_paths(params)
    j_decay = dict(zip([p for p, _ in j_paths], jax.tree_util.tree_leaves(jopt.decay_mask(params))))
    t_decay = topt.decay_mask(tm)
    for parts, use_guide in STAGES.values():
        n_tunable = 0
        for name, jpath in to_jax.items():
            tunable = topt.is_tunable(name, parts, use_guide)
            assert tunable == jopt.is_tunable(jpath, parts, use_guide), (parts, name, jpath)
            n_tunable += tunable
            assert topt.lr_group(name) == jopt.lr_group(jpath), (name, jpath)
            assert t_decay[name] == j_decay[jpath], (name, jpath)
        assert n_tunable > 0
        assert topt.trainable_param_count(tm, parts, use_guide) == jopt.trainable_param_count(params, parts,
                                                                                               use_guide)


@pytest.mark.parametrize("total,warmup,kind", [(20, 0.1, "cosine"), (7, 0.0, "cosine"), (10, 0.03, "cosine"),
                                               (12, 0.25, "constant"), (5, 0.0, "constant")])
def test_schedule_matches_optax(total, warmup, kind):
    ours = topt.make_schedule(1e-3, total, warmup, kind)
    ref = jopt.make_schedule(1e-3, total, warmup, kind)
    for count in range(total + 3):  # count 0 is the first update's
        # optax evaluates in float32: a few float32 ulps of the largest value,
        # lr (near the end of a cosine, 1 + cos cancels in float32)
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-9, err_msg=str(count))


TRAIN = {
    # stage: (tunable parts, use_guide, optimizer arguments)
    "stage1": ("mm_projector", None, dict(learning_rate=1e-3, total_steps=4, warmup_ratio=0.0, eps=1e-6)),
    "stage2": ("mm_projector", "direct", dict(learning_rate=2e-3, guide_injector_lr=1e-3, total_steps=4, eps=1e-6,
                                              warmup_ratio=0.25)),
}


def _port_state(tm, parts, use_guide, opt_kw):
    opt = topt.build_optimizer(tm, tunable_parts=parts, use_guide=use_guide, weight_decay=0.05, **opt_kw)
    return tstep.create_train_state(tm, opt, device="cpu")


@pytest.mark.parametrize("stage", sorted(TRAIN))
def test_two_train_steps_match_jax(stage):
    parts, use_guide, opt_kw = TRAIN[stage]
    jm, params, tm, batch = _pair(use_guide)
    tx = jopt.build_optimizer(params, tunable_parts=parts, use_guide=use_guide, weight_decay=0.05, **opt_kw)
    jstate = jstep.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step_j = jax.jit(jstep.make_train_step(jm, tx, tunable_parts=parts, use_guide=use_guide))
    state = _port_state(tm, parts, use_guide, opt_kw)
    frozen_before = {n: p.detach().clone() for n, p in tm.named_parameters() if not p.requires_grad}
    step_t = tstep.make_train_step()
    for i in range(2):
        jstate, jm_ = step_j(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, tm_ = step_t(state, batch)
        assert int(tm_["target_tokens"]) == int(jm_["target_tokens"])
        # fp32 on both sides, other summation orders through 2 tower, 2 guide
        # and 2 decoder layers: a few float32 ulps of the loss and the norm
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-5, err_msg=f"loss {i}")
        np.testing.assert_allclose(float(tm_["grad_norm"]), float(jm_["grad_norm"]), rtol=1e-4,
                                   err_msg=f"grad_norm {i}")
    assert state.step == 2 and int(jstate.step) == 2
    ref = state_dict_from_jax(jax.device_get(jstate.params))
    got = state.params()
    moved = 0
    for name, t in got.items():
        # Adam divides each gradient by its own running size, so an element
        # whose gradient is within a few eps of zero carries the float32
        # rounding of that gradient into its update (eps = 1e-6 here bounds
        # the gain at 1 / (4 eps)). A hundredth of one step (the learning rate)
        # holds that, while a wrong group rate, decay or bias correction moves
        # elements by a whole step.
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(), rtol=1e-5, atol=0.01 * opt_kw["learning_rate"],
                                   err_msg=name)
        moved += name not in frozen_before and not torch.equal(t, state_dict_from_jax(params)[name])
    assert moved > 0
    for name, before in frozen_before.items():
        assert torch.equal(dict(tm.named_parameters())[name].detach(), before), name


def test_exported_projector_loads_through_jax_converter(tmp_path):
    jm, params, tm, batch = _pair("direct")
    state = _port_state(tm, *TRAIN["stage2"])
    path = tmp_path / "mm_projector.bin"
    tckpt.export_mm_projector_bin(state.params(), str(path))
    sd = jweights.load_torch_bin(str(path))
    assert sd and all(k.startswith("model.mm_projector.") for k in sd)
    got = jweights.convert_projector_state(sd, "hicom")
    got_paths, _ = jopt.tree_paths(got)
    ref_paths = dict(jopt.tree_paths(params["mm_projector"])[0])
    assert {p for p, _ in got_paths} == set(ref_paths)
    for p, v in got_paths:  # fp16 on disk: the values rounded once to fp16
        np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_paths[p]).astype(np.float16).astype(np.float32))


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    parts, use_guide, opt_kw = TRAIN["stage2"]
    batch = _pair(use_guide)[3]
    step = tstep.make_train_step()

    def fresh():
        return _port_state(_pair(use_guide)[2], parts, use_guide, opt_kw)

    a = fresh()
    a, _ = step(a, batch)
    tckpt.save_checkpoint(str(tmp_path), a)
    a, m_a = step(a, batch)

    ckpts = tmp_path / "checkpoints"
    (ckpts / "7.pt.123.tmp").write_bytes(b"partial")  # an interrupted save
    (ckpts / "9.pt").write_bytes(b"")  # an empty step file
    assert tckpt.latest_valid_step(str(tmp_path)) == 1
    assert sorted(p.name for p in ckpts.iterdir()) == ["1.pt"]

    b = fresh()
    assert tckpt.restore_checkpoint(str(tmp_path), b) is b and b.step == 1
    b, m_b = step(b, batch)
    assert float(m_a["loss"]) == float(m_b["loss"]) and b.step == a.step == 2
    for name, t in a.params().items():
        assert torch.equal(t, b.params()[name]), name
    for s in (2, 3, 4):
        tckpt.save_checkpoint(str(tmp_path), b, step=s, max_to_keep=3)
    assert sorted(p.name for p in ckpts.iterdir()) == ["2.pt", "3.pt", "4.pt"]
    assert tckpt.restore_checkpoint(str(tmp_path / "none"), b) is None
