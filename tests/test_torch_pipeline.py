"""Pipeline prefill against the JAX package, in four gloo ranks; the scan layout of JAX's weights.

``tests/torch_ranks.pipeline_worker`` runs ``hicom_tpu_torch.parallel
.pipeline_prefill`` on a 4-layer decoder over a ("pp",) mesh of 4 ranks (one
layer a stage), b 8, L 12, 2 microbatches, with the weights of JAX's
``scan_layers=True`` decoder carried over by ``state_dict_from_jax``. Each
rank's hidden states must equal JAX's ``pipeline_prefill`` on 4 virtual
devices and its cache-less decoder (rtol = atol = 2e-5), and each stage's
layer gradients of sum(hidden^2) JAX's (5e-4), the case of
``tests/test_parallel.py``'s pipeline test.

In this process: ``state_dict_from_jax`` gives the same state dict for the
decoder saved in the scan layout as for the per-layer one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ranks as R
from hicom_tpu.config import tiny_test_config
from hicom_tpu.models.qwen2 import Qwen2ForCausalLM
from hicom_tpu.parallel.pipeline import create_pp_mesh, pipeline_prefill
from hicom_tpu_torch.weights import state_dict_from_jax

WORLD = 4


@pytest.fixture(scope="module")
def jax_refs():
    cfg = dataclasses.replace(tiny_test_config().text_config, num_hidden_layers=4, scan_layers=True)
    model = Qwen2ForCausalLM(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    b, L = 8, 12
    embeds = rng.standard_normal((b, L, cfg.hidden_size)).astype(np.float32)
    positions = np.tile(np.arange(L, dtype=np.int32)[None], (b, 1))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(embeds), jnp.asarray(positions))["params"]
    mesh = create_pp_mesh(4, jax.devices()[:4])

    def direct(p):
        return model.apply({"params": p}, jnp.asarray(embeds), jnp.asarray(positions),
                           method=lambda m, e, pos: m.model(e, pos))[0]

    def pp(p):
        return pipeline_prefill(cfg, p, jnp.asarray(embeds), jnp.asarray(positions), mesh, num_microbatches=2,
                                dtype=jnp.float32)

    hidden = jax.jit(pp)(params)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(pp(p) ** 2)))(params)
    direct_hidden = jax.jit(direct)(params)
    sd = state_dict_from_jax({"language_model": jax.device_get(params)})
    layer_grads = jax.device_get(grads)["model"]["layers"]
    want_grads = state_dict_from_jax({"language_model": {"model": {"layers": layer_grads}}})
    payload = dict(state_dict=sd, embeds=embeds, positions=positions)
    return payload, np.asarray(hidden), np.asarray(direct_hidden), want_grads, jax.device_get(params)


@pytest.fixture(scope="module")
def port(jax_refs, tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    torch.save(jax_refs[0], root / "payload.pt")
    R.spawn(R.pipeline_worker, WORLD, str(root / "payload.pt"), str(root / "out"))
    return [R.load(root / f"out.{r}") for r in range(WORLD)]


def test_hidden_states_match_jax(jax_refs, port):
    _, hidden, direct, _, _ = jax_refs
    np.testing.assert_allclose(hidden, direct, rtol=2e-5, atol=2e-5)
    for rank, res in enumerate(port):
        assert res["no_jax"]
        got = res["hidden"].numpy()
        np.testing.assert_allclose(got, hidden, rtol=2e-5, atol=2e-5, err_msg=f"rank {rank} vs JAX pipeline")
        np.testing.assert_allclose(got, direct, rtol=2e-5, atol=2e-5, err_msg=f"rank {rank} vs the decoder")


@pytest.mark.parametrize("stage", range(WORLD))
def test_stage_gradients_match_jax(jax_refs, port, stage):
    """Stage r holds layer r: its layer's gradients are JAX's; no other
    layer of the decoder has a gradient on that rank."""
    want = jax_refs[3]
    got = {n: g for n, g in port[stage]["grads"].items() if n.startswith("model.layers.")}
    mine = {n for n in want if n.startswith(f"model.layers.{stage}.")}
    assert set(got) == mine
    for name in mine:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=5e-4, atol=5e-4, err_msg=name)


def test_scan_layout_gives_the_per_layer_state_dict(jax_refs):
    from hicom_tpu.weights import unstack_decoder_layers

    params = jax_refs[4]
    stacked = state_dict_from_jax({"language_model": params})
    per_layer = state_dict_from_jax({"language_model": jax.device_get(unstack_decoder_layers(params))})
    assert set(stacked) == set(per_layer) and "model.layers.3.mlp.up_proj.weight" in stacked
    for k, v in per_layer.items():
        assert torch.equal(stacked[k], v), k
