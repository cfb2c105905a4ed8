"""Prompt-lookup speculative decoding and the decoder's per-slot step, port against JAX.

The port's ``pld_draft`` against JAX's ``_pld_draft`` on seeded histories (bit
for bit); ``generate_tokens(spec_k=...)`` against ``spec_k=0`` and against
JAX's ids, under eos, a keyword stop and ``return_stats``; ``spec_k`` ignored
for a batch and for sampling; the decoder's ``per_slot`` step (rows at other
offsets, bitmap holes, stale candidates past an offset) against JAX's
``per_slot=True`` at L = 1 and L = 4 over a float and an int8 cache. fp32 on
the CPU, weights through ``state_dict_from_jax``; ids exactly, the per-slot
step's hidden states to 1e-5 relative (and 1e-5 absolute near zero), int8
codes equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models.generate import _pld_draft as j_draft
from hicom_tpu.models.generate import generate_tokens as j_generate
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu.models.qwen2 import KVCache as JCache
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models.generate import generate_tokens as t_generate
from hicom_tpu_torch.models.generate import pld_draft
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.models.qwen2 import KVCache as TCache
from hicom_tpu_torch.weights import state_dict_from_jax

VIDEO = -201


@pytest.fixture(scope="module")
def tiny():
    """The model, prompt and frames of ``tests/test_spec_decode.py``, and the port's model on its weights."""
    cj, ct = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    jm = JModel(config=cj)
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((1, 4, 3, 56, 56)).astype(np.float32)
    ids = rng.integers(5, cj.text_config.vocab_size, (1, 10))
    ids[0, 3] = VIDEO
    params = jax.jit(lambda i, f: jm.init(jax.random.PRNGKey(0), i, f, modal="video"))(
        jnp.asarray(ids), jnp.asarray(frames))["params"]
    tm = TModel(ct)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(params), ct), strict=True)
    return cj, jm, {"params": params}, tm.eval(), ids, frames


def gen(tiny, spec_k, max_new=24, eos=None, stops=(), stats=False, port=True):
    cj, jm, params, tm, ids, frames = tiny
    kw = dict(modal="video", max_new_tokens=max_new, eos_token_id=cj.text_config.eos_token_id if eos is None else eos,
              cache_len=128, stop_sequences=stops, spec_k=spec_k, return_stats=stats)
    if port:
        out = t_generate(tm, torch.from_numpy(ids), torch.from_numpy(frames), None, None, **kw)
        return (out[0].numpy(), out[1]) if stats else out.numpy()
    out = j_generate(params, jnp.asarray(ids), jnp.asarray(frames), None, None, jax.random.PRNGKey(1), model=jm,
                     has_frames=True, **kw)
    return (np.asarray(out[0]), int(out[1])) if stats else np.asarray(out)


@pytest.mark.parametrize("seed,ngram,k", [(0, 3, 4), (1, 2, 3), (2, 3, 1), (3, 1, 4), (4, 4, 2)])
def test_pld_draft_matches_jax(seed, ngram, k):
    """Histories over a small alphabet (so n-grams recur), lengths from 1 to
    full, one row per length: the port's drafts of all rows at once equal
    JAX's row by row."""
    rng = np.random.default_rng(seed)
    size = 40
    hist = rng.integers(0, 4, (size, size))
    lens = np.arange(1, size + 1)
    got = pld_draft(torch.from_numpy(hist), torch.from_numpy(lens), ngram, k).numpy()
    ref = np.stack([np.asarray(j_draft(jnp.asarray(h, jnp.int32), jnp.int32(n), ngram, k)) for h, n in zip(hist, lens)])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("spec_k", [1, 2, 3, 4])
def test_spec_ids_match_plain_and_jax(tiny, spec_k):
    base = gen(tiny, 0)
    np.testing.assert_array_equal(base, gen(tiny, 0, port=False))
    np.testing.assert_array_equal(gen(tiny, spec_k), base)
    np.testing.assert_array_equal(gen(tiny, spec_k, port=False), base)


def test_spec_with_eos_mid_stream(tiny):
    base = gen(tiny, 0)
    eos = int(base[0, 2])  # an eos the model emits: its 3rd token
    a, b = gen(tiny, 0, eos=eos), gen(tiny, 4, eos=eos)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(b, gen(tiny, 4, eos=eos, port=False))
    assert a[0, 2] == eos and (a[0, 3:] == eos).all()


def test_spec_with_keyword_stop(tiny):
    base = gen(tiny, 0)
    stops = ((int(base[0, 1]), int(base[0, 2])),)  # a 2-token keyword hit at step 2
    a, b = gen(tiny, 0, stops=stops), gen(tiny, 3, stops=stops)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(b, gen(tiny, 3, stops=stops, port=False))
    assert (a[0, 3:] == tiny[0].text_config.eos_token_id).all()


@pytest.mark.parametrize("spec_k", [0, 4])
def test_return_stats_iterations_match_jax(tiny, spec_k):
    """Decode iterations of a 48-token rollout equal JAX's; with drafts the
    tiny model's cycle makes them fewer than the tokens."""
    out, iters = gen(tiny, spec_k, max_new=48, stats=True)
    ref, ref_iters = gen(tiny, spec_k, max_new=48, stats=True, port=False)
    np.testing.assert_array_equal(out, ref)
    assert iters == ref_iters
    if spec_k:
        assert iters < out.shape[1]


def test_spec_ignored_for_batched_or_sampled(tiny):
    """``spec_k`` falls back to the one-token loop for b > 1 and for sampling."""
    cj, jm, params, tm, _, _ = tiny
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((2, 4, 3, 56, 56)).astype(np.float32)
    ids = rng.integers(5, cj.text_config.vocab_size, (2, 9))
    ids[:, 2] = VIDEO
    kw = dict(modal="video", max_new_tokens=6, eos_token_id=cj.text_config.eos_token_id, cache_len=128)
    args = (torch.from_numpy(ids), torch.from_numpy(frames), None, None)
    a = t_generate(tm, *args, spec_k=0, **kw)
    np.testing.assert_array_equal(t_generate(tm, *args, spec_k=4, **kw).numpy(), a.numpy())
    ref = j_generate(params, jnp.asarray(ids), jnp.asarray(frames), None, None, jax.random.PRNGKey(1), model=jm,
                     has_frames=True, spec_k=4, **kw)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref))
    one = (args[0][:1], args[1][:1], None, None)
    s0 = t_generate(tm, *one, spec_k=0, temperature=0.8, generator=torch.Generator().manual_seed(5), **kw)
    s4 = t_generate(tm, *one, spec_k=4, temperature=0.8, generator=torch.Generator().manual_seed(5), **kw)
    np.testing.assert_array_equal(s4.numpy(), s0.numpy())


@pytest.fixture(scope="module")
def decoder(tiny):
    cj, jm, params, tm, _, _ = tiny
    return cj.text_config, params["params"]["language_model"], tm


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("int8", [False, True])
def test_per_slot_step_matches_jax(decoder, L, int8):
    """Three rows at offsets 9, 17 and 30 of a 48-slot cache with pad holes,
    the last row with stale valid slots past its offset (an unaccepted
    speculative chunk): JAX's ``per_slot=True`` step and the port's give the
    same hidden states and the same written cache; the port leaves
    ``lengths`` to its caller."""
    from hicom_tpu.models.qwen2 import Qwen2Model as JDecoder

    tc, lm_params, tm = decoder
    rng = np.random.default_rng(11 + L + 10 * int8)
    b, S, KVH, hd, nl = 3, 48, tc.num_key_value_heads, tc.head_dim, tc.num_hidden_layers
    lengths = np.array([9, 17, 30])
    valid = np.arange(S)[None, :] < lengths[:, None]
    valid[1, 5:12] = False  # a right-padded prompt's pad slots
    valid[2, 30:36] = True  # stale candidates beyond the offset
    shape = (nl, b, KVH, S, hd)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks, vs = (rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32) for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        ks = vs = None
    emb = rng.standard_normal((b, L, tc.hidden_size)).astype(np.float32)
    pos = (np.array([7, 20, 26])[:, None] + np.arange(L)).astype(np.int64)

    jc = JCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths, jnp.int32), jnp.asarray(valid),
                None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs))
    dec = JDecoder(config=tc, dtype=jnp.float32)
    ref, jc2 = jax.jit(lambda p, e, q, c: dec.apply({"params": p}, e, q, c, per_slot=True))(
        lm_params["model"], jnp.asarray(emb), jnp.asarray(pos), jc)

    th = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    tcache = TCache(th(k), th(v), th(valid), 0, th(ks), th(vs), torch.from_numpy(lengths))
    with torch.inference_mode():
        got = tm.model(torch.from_numpy(emb), torch.from_numpy(pos), tcache, per_slot=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tcache.lengths.numpy(), lengths)
    np.testing.assert_array_equal(np.asarray(jc2.length), lengths + L)
    np.testing.assert_array_equal(tcache.valid.numpy(), np.asarray(jc2.valid))
    if int8:
        np.testing.assert_array_equal(tcache.k.numpy(), np.asarray(jc2.k))
        np.testing.assert_array_equal(tcache.v.numpy(), np.asarray(jc2.v))
        np.testing.assert_allclose(tcache.k_scale.numpy(), np.asarray(jc2.k_scale), rtol=1e-6)
        np.testing.assert_allclose(tcache.v_scale.numpy(), np.asarray(jc2.v_scale), rtol=1e-6)
    else:
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jc2.k), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jc2.v), rtol=1e-5, atol=1e-6)


def test_shared_offset_chunk_step_matches_full_forward(decoder):
    """The non-per-slot step of L > 1 tokens over a filled cache (the b = 1
    speculative loop's verify step) equals the cache-less forward over the
    whole sequence at those positions."""
    tc, _, tm = decoder
    rng = np.random.default_rng(3)
    P, L = 10, 4
    emb = torch.from_numpy(rng.standard_normal((1, P + L, tc.hidden_size)).astype(np.float32))
    pos = torch.arange(P + L)[None]
    cache = TCache.zeros(tc.num_hidden_layers, 1, tc.num_key_value_heads, 32, tc.head_dim, torch.float32, "cpu")
    with torch.inference_mode():
        tm.model(emb[:, :P], pos[:, :P], cache, None, True)
        got = tm.model(emb[:, P:], pos[:, P:], cache)
        full = tm.model(emb, pos)
    assert cache.length == P + L
    np.testing.assert_allclose(got.numpy(), full[:, P:].numpy(), rtol=1e-5, atol=1e-5)
