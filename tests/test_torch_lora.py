"""LoRA, activation checkpointing and gradient accumulation of the port against the JAX package.

On the tiny model in fp32, with the JAX model's weights carried over:

* the LoRA targets are JAX's ``target_kernels``; with JAX's adapters carried
  over (B drawn nonzero so they act), the side-path ``LoRA`` module and the
  merged ``apply_lora`` give JAX's ``make_lora_loss_fn`` loss and adapter
  gradients; peft adapter files cross the packages both ways;
* ``remat=True`` gives the loss and gradients of ``remat=False`` (bit-equal:
  the recompute repeats the same CPU ops) and JAX's with ``remat=True``;
* two micro-batches at ``gradient_accumulation_steps=2`` give the parameters
  of ``optax.MultiSteps`` after its one update.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu.train import lora as jlora
from hicom_tpu.train import optimizer as jopt
from hicom_tpu.train import train_step as jstep
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.train import lora as tlora
from hicom_tpu_torch.train import optimizer as topt
from hicom_tpu_torch.train import train_step as tstep
from hicom_tpu_torch.weights import state_dict_from_jax

VIDEO, IGNORE = -201, -100
STAGE3 = "mm_projector,language_model,vision_model_head,guide_encoder"


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.text_config.vocab_size, (2, 12))
    ids[:, 2] = VIDEO
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    ids[1, 9:] = 0
    labels = np.where(mask, ids, IGNORE)
    labels[:, :4] = IGNORE
    size = cfg.vision_config.image_size
    return dict(input_ids=ids, attention_mask=mask, labels=labels,
                frames=rng.standard_normal((2, 4, 3, size, size)).astype(np.float32),
                guide_ids=rng.integers(1, cfg.guide_text_config.vocab_size, (2, 16)))


def _pair(remat=False):
    jm, params, ct, batch = _jax_model(remat)
    tm = TModel(ct)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm, batch


@functools.cache
def _jax_model(remat):
    kw = dict(use_guide="direct")
    cj, ct = jcfg.tiny_test_config(**kw), tcfg.tiny_test_config(**kw)
    if remat:
        cj = cj.replace(text_config=dataclasses.replace(cj.text_config, remat=True),
                        vision_config=dataclasses.replace(cj.vision_config, remat=True))
        ct = ct.replace(text_config=dataclasses.replace(ct.text_config, remat=True),
                        vision_config=dataclasses.replace(ct.vision_config, remat=True))
    batch = _batch(cj)
    jm = JModel(config=cj)
    init = jax.jit(lambda *a: jm.init(*a, guide_ids=jnp.asarray(batch["guide_ids"]))["params"])
    params = jax.device_get(init(jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]), jnp.asarray(batch["frames"])))
    return jm, params, ct, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_adapters(params, rank=4):
    lora = jlora.init_lora_params(params, rank=rank, rng=jax.random.PRNGKey(1))
    keys = jax.random.split(jax.random.PRNGKey(2), len(lora))
    return {p: {"a": ab["a"], "b": jax.random.normal(k, ab["b"].shape) * 0.05}
            for (p, ab), k in zip(sorted(lora.items()), keys)}


def test_targets_match_jax():
    _, params, tm, _ = _pair()
    want = {n: s for n, s in tlora.lora_from_jax(
        {p: {"a": np.zeros(1), "b": np.zeros(1)} for p in jlora.target_kernels(params)}).items()}
    got = tlora.target_kernels(tm)
    assert set(got) == set(want) and len(got) == 7 * 2
    for path, (din, dout) in jlora.target_kernels(params).items():
        name = next(iter(tlora.lora_from_jax({path: {"a": np.zeros(1), "b": np.zeros(1)}})))
        assert got[name] == (din, dout), name
    fresh = tlora.init_lora_params(tm, rank=3, generator=torch.Generator().manual_seed(0))
    assert set(fresh) == set(got)
    for name, ab in fresh.items():
        assert ab["a"].shape == (got[name][0], 3) and not ab["b"].any()


def _jax_lora_loss_and_grads(jm, params, lora, batch, alpha, rank):
    loss_fn = jlora.make_lora_loss_fn(jstep.make_loss_fn(jm), params, alpha=alpha, rank=rank)
    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(lora, _jbatch(batch))
    return float(loss), tlora.lora_from_jax(jax.device_get(grads))


@pytest.mark.parametrize("form", ["side_path", "apply_lora"])
def test_lora_loss_and_grads_match_jax(form):
    jm, params, tm, batch = _pair()
    alpha, rank = 8.0, 4
    jl = _jax_adapters(params, rank)
    ref_loss, ref_grads = _jax_lora_loss_and_grads(jm, params, jl, batch, alpha, rank)
    lora = tlora.lora_from_jax(jax.device_get(jl))
    for p in tm.parameters():
        p.requires_grad_(False)
    loss_fn = tstep.make_loss_fn(tm)
    tb = tstep.batch_to_device(batch, torch.device("cpu"), torch.float32)
    if form == "side_path":
        module = tlora.LoRA(lora, alpha, rank).attach(tm)
        loss, _ = loss_fn(tb)
        loss.backward()
        grads = {n: {"a": module.a[tlora._key(n)].grad, "b": module.b[tlora._key(n)].grad} for n in module.names}
        module.detach()
    else:  # the merged weights, differentiated through torch.func.functional_call
        leaves = {n: {k: v.clone().requires_grad_() for k, v in ab.items()} for n, ab in lora.items()}

        class Loss(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.m = tm

            def forward(self, b):
                return loss_fn(b)[0]

        merged = tlora.apply_lora(dict(tm.named_parameters()), leaves, alpha, rank)
        loss = torch.func.functional_call(Loss(), {f"m.{k}": v for k, v in merged.items()}, (tb,))
        loss.backward()
        grads = {n: {k: v.grad for k, v in ab.items()} for n, ab in leaves.items()}
    # fp32 on both sides through 2 tower, 2 guide and 2 decoder layers, other
    # summation orders: a few float32 ulps (gradients: of their largest element)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    assert set(grads) == set(ref_grads)
    for n, ab in grads.items():
        for k in ("a", "b"):
            ref = ref_grads[n][k].numpy()
            np.testing.assert_allclose(ab[k].numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(), err_msg=n + k)


def test_peft_adapters_cross_packages(tmp_path):
    _, params, tm, _ = _pair()
    jl = jax.device_get(_jax_adapters(params))
    jlora.export_peft_adapter(jl, str(tmp_path / "from_jax"), alpha=8.0, rank=4)
    got, alpha, rank = tlora.load_peft_adapter(str(tmp_path / "from_jax"))
    want = tlora.lora_from_jax(jl)
    assert (alpha, rank) == (8.0, 4) and set(got) == set(want)
    for n in want:
        for k in ("a", "b"):
            assert torch.equal(got[n][k], want[n][k]), n
    tlora.export_peft_adapter(want, str(tmp_path / "from_port"), alpha=8.0, rank=4)
    back, alpha, rank = jlora.load_peft_adapter(str(tmp_path / "from_port"))
    assert (alpha, rank) == (8.0, 4) and set(back) == set(jl)
    for p, ab in jl.items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(back[p][k]), np.asarray(ab[k]), err_msg=p)


def _port_grads(tm, batch, parts):
    topt.build_optimizer(tm, learning_rate=1e-3, tunable_parts=parts, use_guide="direct").init(tm)
    loss, _ = tstep.make_loss_fn(tm)(tstep.batch_to_device(batch, torch.device("cpu"), torch.float32))
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in tm.named_parameters() if p.grad is not None}


def test_remat_matches_no_remat_and_jax():
    _, _, tm0, batch = _pair(remat=False)
    jm, params, tm1, _ = _pair(remat=True)
    loss0, g0 = _port_grads(tm0, batch, STAGE3)
    loss1, g1 = _port_grads(tm1, batch, STAGE3)
    assert loss0 == loss1 and set(g0) == set(g1) and len(g0) > 50
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    loss_fn = jstep.make_loss_fn(jm, tunable_parts=STAGE3, use_guide="direct")
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, _jbatch(batch))
    ref = state_dict_from_jax(jax.device_get(jgrads))
    # fp32, other summation orders: a few float32 ulps of the loss, and of the
    # largest gradient element (some tensors' gradients are rounding noise)
    np.testing.assert_allclose(loss1, float(jloss), rtol=1e-5)
    top = max(float(np.abs(r.numpy()).max()) for r in ref.values())
    for n, g in g1.items():
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), rtol=1e-4, atol=1e-5 * top, err_msg=n)


def test_accumulation_matches_optax_multisteps():
    jm, params, tm, batch = _pair()
    batch2 = _batch(jm.config, seed=1)
    # eps 1e-4: Adam's gain on a gradient within a few eps of zero stays
    # small enough that float32 rounding of the mean gradient cannot reach
    # the tolerance, while a missing or wrong micro-batch moves a whole step
    kw = dict(learning_rate=2e-3, guide_injector_lr=1e-3, total_steps=4, warmup_ratio=0.0, eps=1e-4,
              tunable_parts="mm_projector", use_guide="direct", weight_decay=0.05)
    tx = optax.MultiSteps(jopt.build_optimizer(params, **kw), 2)
    step_j = jax.jit(jstep.make_train_step(jm, tx, tunable_parts="mm_projector", use_guide="direct"))
    jstate = jstep.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    state = tstep.create_train_state(tm, topt.build_optimizer(tm, gradient_accumulation_steps=2, **kw), device="cpu")
    before = {n: t.clone() for n, t in state.params().items()}
    step_t = tstep.make_train_step()
    for i, b in enumerate((batch, batch2)):
        jstate, jm_ = step_j(jstate, _jbatch(b))
        state, tm_ = step_t(state, b)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm_["grad_norm"]), float(jm_["grad_norm"]), rtol=1e-4)
        if i == 0:  # the first micro-batch only accumulates
            assert all(torch.equal(t, before[n]) for n, t in state.params().items())
    assert state.optimizer.count == 1 and state.optimizer.mini_step == 0
    ref = state_dict_from_jax(jax.device_get(jstate.params))
    moved = 0
    for name, t in state.params().items():
        # a hundredth of one step (the learning rate)
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(), rtol=1e-5, atol=0.01 * kw["learning_rate"],
                                   err_msg=name)
        moved += not torch.equal(t, before[name])
    assert moved > 0
