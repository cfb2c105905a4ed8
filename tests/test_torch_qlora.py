"""QLoRA of the port against the JAX package.

On the tiny model in fp32, with the JAX model's weights carried over and the
decoder quantized by both packages' converters (bit-equal codes):

* the side path over an NF4 and an int8 base gives JAX's
  ``make_qlora_loss_fn`` loss (rtol 1e-5) and adapter gradients (rtol 1e-5,
  atol 1e-5 of the largest: fp32 through the same dequantized weights,
  other summation orders);
* the trainer's side path (a ``LoRA`` attached for the whole run, the CLI's
  route) gives the loss function's loss and gradients at the activations'
  dtype (rtol 1e-6: the same fp32 products), and the loss function leaves
  no hook behind;
* LoRA's target finder sees the quantized linears, with their float shapes;
* ``estimate_qlora_memory`` returns JAX's dict, float for float;
* the CLI's ``--bits 4/8``: ``tests/test_torch_qlora_cli.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models import qwen2 as jq2
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu.train import lora as jlora
from hicom_tpu.train import train_step as jstep
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models import quant as tq
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.train import lora as tlora
from hicom_tpu_torch.train import train_step as tstep
from hicom_tpu_torch.weights import state_dict_from_jax

from test_torch_lora import _jax_adapters, _jax_model, _jbatch


@functools.cache
def _quantized(mode):
    jm, params, ct, batch = _jax_model(False)
    qparams = {**params, "language_model": jq2.quantize_decoder_params(params["language_model"], mode)}
    cj = jm.config
    qjm = JModel(config=cj.replace(text_config=dataclasses.replace(cj.text_config, quantization=mode)))
    tm = TModel(ct.replace(text_config=dataclasses.replace(ct.text_config, quantization=mode)))
    tm.load_state_dict(state_dict_from_jax(qparams), strict=True)
    return qjm, qparams, params, tm, batch


@pytest.mark.parametrize("mode", ["nf4", "int8"])
def test_qlora_loss_and_grads_match_jax(mode):
    qjm, qparams, params, tm, batch = _quantized(mode)
    alpha, rank = 8.0, 4
    jl = _jax_adapters(params, rank)
    loss_fn = jlora.make_qlora_loss_fn(jstep.make_loss_fn(qjm), qparams, alpha=alpha, rank=rank,
                                       compute_dtype=jnp.float32)
    (ref_loss, _), ref = jax.value_and_grad(loss_fn, has_aux=True)(jl, _jbatch(batch))
    ref = tlora.lora_from_jax(jax.device_get(ref))

    for p in tm.parameters():
        p.requires_grad_(False)
    leaves = {n: {k: v.clone().requires_grad_() for k, v in ab.items()}
              for n, ab in tlora.lora_from_jax(jax.device_get(jl)).items()}
    tloss = tlora.make_qlora_loss_fn(tstep.make_loss_fn(tm), tm, alpha=alpha, rank=rank, compute_dtype=torch.float32)
    loss, _ = tloss(leaves, tstep.batch_to_device(batch, torch.device("cpu"), torch.float32))
    loss.backward()
    assert not any(m._forward_hooks for m in tm.modules())  # the side path left with the call
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert set(leaves) == set(ref)
    for n, ab in leaves.items():
        for k in ("a", "b"):
            want = ref[n][k].numpy()
            np.testing.assert_allclose(ab[k].grad.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                                       err_msg=n + k)


@pytest.mark.parametrize("mode", ["nf4", "int8"])
def test_trainer_side_path_matches_qlora_loss_fn(mode):
    _, _, params, tm, batch = _quantized(mode)
    for p in tm.parameters():
        p.requires_grad_(False)
    adapters = tlora.lora_from_jax(jax.device_get(_jax_adapters(params, 4)))
    tb = tstep.batch_to_device(batch, torch.device("cpu"), torch.float32)
    leaves = {n: {k: v.clone().requires_grad_() for k, v in ab.items()} for n, ab in adapters.items()}
    loss_fn = tlora.make_qlora_loss_fn(tstep.make_loss_fn(tm), tm, alpha=8.0, rank=4, compute_dtype=torch.float32)
    want, _ = loss_fn(leaves, tb)
    want.backward()
    assert not any(m._forward_hooks for m in tm.modules())

    trainer = tlora.LoRA(adapters, 8.0, 4).attach(tm)
    try:
        assert trainer.compute_dtype is None  # the activations' dtype
        got, _ = tstep.make_loss_fn(tm)(tb)
        got.backward()
    finally:
        trainer.detach()
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    for n in adapters:
        for k in ("a", "b"):
            ref = leaves[n][k].grad.numpy()
            np.testing.assert_allclose(trainer.a[tlora._key(n)].grad.numpy() if k == "a" else
                                       trainer.b[tlora._key(n)].grad.numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=n + k)


@pytest.mark.parametrize("mode", ["nf4", "int8"])
def test_targets_see_quantized_linears(mode):
    _, qparams, params, tm, _ = _quantized(mode)
    got = tlora.target_kernels(tm)
    want = tlora.lora_from_jax({p: {"a": np.zeros(1), "b": np.zeros(1)} for p in jlora.target_kernels(qparams)})
    assert len(got) == 7 * 2 and set(got) == set(want)
    kinds = {type(m) for n, m in tm.named_modules() if n in got}
    assert kinds == {tq.QuantLinear4 if mode == "nf4" else tq.QuantLinear}
    for path, shape in jlora.target_kernels(params).items():  # the float tree's shapes
        assert got[next(iter(tlora.lora_from_jax({path: {"a": np.zeros(1), "b": np.zeros(1)}})))] == shape
    fresh = tlora.init_lora_params(tm, rank=3)
    assert set(fresh) == set(got)


@pytest.mark.parametrize("bits,rank,tokens", [(4, 64, 4096), (8, 128, 8192), (4, 8, 512)])
def test_estimate_qlora_memory_matches_jax(bits, rank, tokens):
    for j, t in ((jcfg.Qwen2Config(), tcfg.Qwen2Config()), (jcfg.tiny_test_config().text_config,
                                                           tcfg.tiny_test_config().text_config)):
        assert tlora.estimate_qlora_memory(t, bits, rank, tokens) == jlora.estimate_qlora_memory(j, bits, rank, tokens)
