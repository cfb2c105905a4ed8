"""K3 at the decoder widths the JAX package takes beyond head dim 128: head dim
64 at group 7 (Qwen2.5-0.5B's 14 / 2 heads), groups 5 and 3 at head dim 128,
against the JAX package on the CPU.

``decode_reference`` (the plain twin) and ``chunked_decode_reference`` (the
CUDA kernel's 32-slot chunked order in plain PyTorch) against the Pallas
decode kernel in interpret mode, inputs from a numpy seed, over 600 slots (two
of the Pallas kernel's 512-slot blocks, a last 32-slot chunk past the end),
with valid slots ending inside a chunk, a ragged row, and a float or an int8
cache with per-slot scales:

* float32: 2e-5 (rtol and atol), the tolerance of the other decode tests:
  the same fp32 arithmetic, the sums in another order;
* bfloat16 (a bf16 query over a bf16 or int8 cache, the model's types): each
  element within 2^-6 |ref| + 2^-5 rms(ref), the kernels' gate on the card
  (both sides round p and the output to bf16, the Pallas kernel against its
  block's running max, the twin against the row's).

Then a 2-layer decoder with Qwen2.5-0.5B's head geometry (14 / 2 heads of 64,
tied embeddings, rope theta 1e6) and narrow elsewhere, its weights carried
from JAX by ``state_dict_from_jax``: prefill and 8 greedy decode steps in fp32
on the CPU, the logits of every step within 1e-4 (rtol and atol, the decoder
tests' tolerance: two layers in another summation order) of JAX's, the greedy
ids equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models.qwen2 import KVCache as JCache
from hicom_tpu.models.qwen2 import Qwen2ForCausalLM as JLM
from hicom_tpu.ops.flash_decode import flash_decode as j_flash_decode
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models.qwen2 import KVCache as TCache
from hicom_tpu_torch.models.qwen2 import Qwen2ForCausalLM as TLM
from hicom_tpu_torch.ops import flash_decode as tfd
from hicom_tpu_torch.weights import state_dict_from_jax

F32_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
WIDTHS = {  # name: (kv heads, group, head dim)
    "0.5b d64 g7": (2, 7, 64),
    "g5 d128": (2, 5, 128),
    "g3 d128": (2, 3, 128),
}


def _gate(got, ref):
    """The largest error over its tolerance 2^-6 |ref| + 2^-5 rms(ref) (passes at <= 1)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    rms = np.sqrt(np.mean(ref**2))
    return float(np.max(np.abs(got - ref) / (2**-6 * np.abs(ref) + 2**-5 * rms)))


def _inputs(width, quantized, seed):
    KVH, g, d = WIDTHS[width]
    b, S = 2, 600
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, KVH * g, 1, d)).astype(np.float32)
    slot = np.arange(S)
    # row 0: valid slots ending inside a chunk and past the first 512-slot block; row 1 ragged
    mask = np.stack([slot < 587, rng.random(S) < np.where(slot < 300, 0.6, 0.1)])
    mask[1, 0] = True
    if quantized:
        k = rng.integers(-127, 128, (b, KVH, S, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, KVH, S, d)).astype(np.int8)
        ks = (rng.random((b, KVH, S)) * 0.02).astype(np.float32)
        vs = (rng.random((b, KVH, S)) * 0.02).astype(np.float32)
    else:
        k = rng.standard_normal((b, KVH, S, d)).astype(np.float32)
        v = rng.standard_normal((b, KVH, S, d)).astype(np.float32)
        ks = vs = None
    return q, k, v, mask, ks, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_decode_twins_match_pallas_at_new_widths(width, quantized, dtype):
    q, k, v, mask, ks, vs = _inputs(width, quantized, seed=len(width) + 2 * quantized)
    jt, tt = jnp.dtype(dtype), getattr(torch, dtype)
    jx = lambda x, cast=True: None if x is None else jnp.asarray(x).astype(jt if cast else x.dtype)  # noqa: E731
    tx = lambda x, cast=True: None if x is None else torch.from_numpy(x).to(tt if cast else None)  # noqa: E731
    cache_cast = not quantized  # int8 codes stay codes; a float cache takes the query's type
    ref = j_flash_decode(jx(q), jx(k, cache_cast), jx(v, cache_cast), jnp.asarray(mask), k_scale=jx(ks, False),
                         v_scale=jx(vs, False), interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    args = (tx(q), tx(k, cache_cast), tx(v, cache_cast), torch.from_numpy(mask), tx(ks, False), tx(vs, False),
            q.shape[-1] ** -0.5)
    for twin in (tfd.decode_reference, tfd.chunked_decode_reference):
        got = twin(*args)
        assert got.dtype == tt and got.shape == q.shape
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)
        else:
            assert _gate(got.float().numpy(), ref) <= 1, twin.__name__


def _05b_geometry(cfg):
    return dataclasses.replace(cfg.text_config, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                               num_attention_heads=14, num_key_value_heads=2, head_dim=64, vocab_size=256,
                               rope_theta=1e6, tie_word_embeddings=True)


@functools.lru_cache(maxsize=None)
def _models():
    cj, ct = _05b_geometry(jcfg.tiny_test_config()), _05b_geometry(tcfg.tiny_test_config())
    ids = np.arange(12)[None] % cj.vocab_size
    jm = JLM(config=cj)
    params = jax.jit(lambda i, p: jm.init(jax.random.PRNGKey(4), i, p, method=lambda m, i, p: m(m.embed(i), p)))(
        jnp.asarray(ids), jnp.asarray(np.arange(12)[None]))["params"]
    tm = TLM(ct, dtype=torch.float32)
    tm.load_state_dict(state_dict_from_jax({"language_model": jax.device_get(params)}), strict=True)
    return cj, jm, params, tm.eval()


@pytest.mark.parametrize("int8", [False, True])
def test_05b_head_geometry_decodes_jax_greedy_ids(int8):
    cj, jm, params, tm = _models()
    rng = np.random.default_rng(21 + int8)
    b, L, steps, S = 2, 10, 8, 32
    prompt = rng.integers(3, cj.vocab_size, (b, L))
    pm = np.ones((b, L), bool)
    pm[1, 7:] = False  # row 1 right-padded: its tokens sit at rope positions from 7, in slots from L

    def jrun(method):
        return jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=method), static_argnums=(5,))

    jprefill = jrun(lambda m, e, pos, c, mask, _: m.model(e, pos, c, mask, True))
    jstep = jrun(lambda m, e, pos, c, mask, _: m.model(e, pos, c))
    jembed = jax.jit(lambda p, i: jm.apply({"params": p}, i, method=lambda m, i: m.embed(i)))
    jlogits = jax.jit(lambda p, h: jm.apply({"params": p}, h, method=lambda m, h: m.logits(h)))

    jc = JCache.zeros(cj.num_hidden_layers, b, cj.num_key_value_heads, S, cj.head_dim, jnp.float32, quantized=int8)
    tc = TCache.zeros(cj.num_hidden_layers, b, cj.num_key_value_heads, S, cj.head_dim, torch.float32, "cpu",
                      quantized=int8)
    pos = np.broadcast_to(np.arange(L), (b, L)).copy()
    jh, jc = jprefill(params, jembed(params, jnp.asarray(prompt)), jnp.asarray(pos), jc, jnp.asarray(pm), 0)
    with torch.no_grad():
        th = tm.model(tm.embed(torch.from_numpy(prompt)), torch.from_numpy(pos), tc, torch.from_numpy(pm), True)
    last = pm.sum(axis=1) - 1
    tlogits = lambda h: tm.logits(h).detach().numpy()  # noqa: E731
    jl, tl = np.asarray(jlogits(params, jh))[np.arange(b), last], tlogits(th)[np.arange(b), last]
    ids_j, ids_t, next_pos = [], [], last + 1
    for step in range(steps):
        np.testing.assert_allclose(tl, jl, **LOGIT_TOL, err_msg=f"step {step}")
        ids_j.append(jl.argmax(-1))
        ids_t.append(tl.argmax(-1))
        tok, p = ids_j[-1][:, None], next_pos[:, None]
        jh, jc = jstep(params, jembed(params, jnp.asarray(tok)), jnp.asarray(p), jc, None, 0)
        with torch.no_grad():
            th = tm.model(tm.embed(torch.from_numpy(ids_t[-1][:, None])), torch.from_numpy(p), tc)
        jl, tl = np.asarray(jlogits(params, jh))[:, 0], tlogits(th)[:, 0]
        next_pos = next_pos + 1
    assert np.array_equal(np.stack(ids_t), np.stack(ids_j))
    assert tc.length == L + steps
