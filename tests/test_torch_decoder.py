"""Port Qwen2 decoder vs the JAX module: logits with and without right padding,
and the decode step over a bf16-layout (fp32 here) and an int8 KV cache.

fp32 on the CPU, weights through state_dict_from_jax. Tolerance 1e-4 (absolute
and relative) on O(1) logits: two decoder layers in another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models.qwen2 import KVCache as JCache
from hicom_tpu.models.qwen2 import Qwen2ForCausalLM as JLM
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models.qwen2 import KVCache as TCache
from hicom_tpu_torch.models.qwen2 import Qwen2ForCausalLM as TLM
from hicom_tpu_torch.weights import state_dict_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    cj = jcfg.tiny_test_config().text_config
    ct = tcfg.tiny_test_config().text_config
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cj.vocab_size, (2, 12))
    pos = np.broadcast_to(np.arange(12), (2, 12))
    jm = JLM(config=cj)
    # through embed too, so the embedding table is created
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(pos),
                     method=lambda m, i, p: m(m.embed(i), p))["params"]
    tm = TLM(ct, dtype=torch.float32)
    tm.load_state_dict(state_dict_from_jax({"language_model": jax.device_get(params)}), strict=True)
    return cj, jm, params, tm.eval()


@pytest.mark.parametrize("padded", [False, True])
def test_logits_match_jax(models, padded):
    cj, jm, params, tm = models
    rng = np.random.default_rng(1 + padded)
    b, L = 2, 20
    emb = rng.standard_normal((b, L, cj.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(L), (b, L)).copy()
    pm = None
    if padded:
        pm = np.ones((b, L), bool)
        pm[0, 13:] = False
    ref, _ = jm.apply({"params": params}, jnp.asarray(emb), jnp.asarray(pos),
                      None, None if pm is None else jnp.asarray(pm))
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(emb), torch.from_numpy(pos), None, None if pm is None else torch.from_numpy(pm))
    ref, got = np.asarray(ref), got.numpy()
    if padded:  # padded query rows carry values nobody reads
        ref, got = ref[pm], got[pm]
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_step_matches_jax_and_full_forward(models, int8):
    cj, jm, params, tm = models
    rng = np.random.default_rng(5)
    b, L, S = 2, 10, 32
    emb = rng.standard_normal((b, L + 1, cj.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(L + 1), (b, L + 1)).copy()
    pm = np.ones((b, L), bool)
    pm[1, 7:] = False  # row 1 right-padded: its decode token sits at rope position 7, slot L

    def jmodel(m, *a):
        return m.model(*a)

    jc = JCache.zeros(cj.num_hidden_layers, b, cj.num_key_value_heads, S, cj.head_dim, jnp.float32, quantized=int8)
    _, jc = jm.apply({"params": params}, jnp.asarray(emb[:, :L]), jnp.asarray(pos[:, :L]), jc, jnp.asarray(pm),
                     True, method=jmodel)
    step_pos = np.array([[L], [7]])
    jh, _ = jm.apply({"params": params}, jnp.asarray(emb[:, L:]), jnp.asarray(step_pos), jc, method=jmodel)
    ref = np.asarray(jm.apply({"params": params}, jh, method=lambda m, h: m.logits(h)))

    tc = TCache.zeros(cj.num_hidden_layers, b, cj.num_key_value_heads, S, cj.head_dim, torch.float32, "cpu",
                      quantized=int8)
    with torch.no_grad():
        tm.model(torch.from_numpy(emb[:, :L]), torch.from_numpy(pos[:, :L]), tc, torch.from_numpy(pm), True)
        th = tm.model(torch.from_numpy(emb[:, L:]), torch.from_numpy(step_pos), tc)
        got = tm.logits(th).numpy()
    assert tc.length == L + 1
    np.testing.assert_allclose(got, ref, **TOL)

    if not int8:
        # the cached step equals a full forward over [prompt ; token] for the unpadded row
        with torch.no_grad():
            full, _ = tm(torch.from_numpy(emb[:1]), torch.from_numpy(pos[:1]))
        np.testing.assert_allclose(got[0, -1], full[0, -1].numpy(), **TOL)


def test_kv_quantization_matches_jax():
    from hicom_tpu.models.qwen2 import dequantize_kv as j_deq
    from hicom_tpu.models.qwen2 import quantize_kv as j_quant
    from hicom_tpu_torch.models.qwen2 import dequantize_kv as t_deq
    from hicom_tpu_torch.models.qwen2 import quantize_kv as t_quant

    x = np.random.default_rng(9).standard_normal((2, 3, 17, 32)).astype(np.float32)
    jq, js = j_quant(jnp.asarray(x))
    tq, ts = t_quant(torch.from_numpy(x))
    # both round x / scale half-to-even in fp32; the scales are one fp32 division
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(t_deq(tq, ts, torch.float32).numpy(), np.asarray(j_deq(jq, js, jnp.float32)),
                               rtol=1e-6)


def test_top_p_sampling_keeps_the_nucleus():
    from hicom_tpu_torch.models.generate import sample_token

    logits = torch.tensor([[0.0, 5.0, 4.9, -3.0], [2.0, 0.0, 0.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    # a nucleus smaller than the top token's mass keeps only the argmax
    for _ in range(20):
        assert sample_token(logits, gen, 1.0, 0.1).tolist() == [1, 0]
    # top_p = 0.9 over row 0 keeps tokens 1 and 2 (0.52 + 0.47 > 0.9), never 0 or 3
    draws = {int(sample_token(logits, gen, 1.0, 0.9)[0]) for _ in range(200)}
    assert draws == {1, 2}


def test_decode_loop_reports_each_step(models):
    """``on_token(step)`` runs once per generated step, and not past a stop."""
    from hicom_tpu_torch.models.generate import sample_and_loop

    cj, _, _, tm = models
    emb = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 6, cj.hidden_size)).astype(np.float32))
    pos = torch.arange(6)[None].clone()

    def run(eos):
        cache = TCache.zeros(cj.num_hidden_layers, 1, cj.num_key_value_heads, 32, cj.head_dim, torch.float32, "cpu")
        seen = []
        with torch.no_grad():
            hidden = tm.model(emb, pos, cache, None, True)
            out = sample_and_loop(tm, cache, hidden[:, -1:], torch.tensor([6]), 5, 0.0, 0.9, eos, (),
                                  on_token=seen.append)
        return out, seen

    out, seen = run(-1)
    assert seen == [0, 1, 2, 3, 4]
    _, seen = run(int(out[0, 0]))  # the first token is eos: the loop stops after step 0
    assert seen == [0]
