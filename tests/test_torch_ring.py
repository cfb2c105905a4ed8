"""Ring attention, the ring prefill and the ring route of ``HICom.generate``
against the JAX package, in gloo groups.

``tests/torch_ranks.ring_worker`` runs in 2 and 4 gloo rank processes, each
rank holding one chunk of the sequence (``hicom_tpu_torch.parallel.ring``):

* ``ring_self_attention`` over b 2, 4 query / 2 kv heads, L 128, d 16, causal
  with and without global kv lengths (100 and 128) and non-causal with them:
  equal to JAX's ``ring_self_attention`` on the 8 virtual CPU devices and to
  the port's ``sdpa`` on the whole sequence (rtol = atol = 2e-5);
* ``ring_prefill`` of 21 embeddings (padded to 22 or 24 for the ranks, 24 in
  JAX) into a 32-slot cache: the last token's hidden state and the cache's
  k/v up to 21 against JAX's ``ring_prefill`` (2e-5), its length and
  validity exactly;
* ``HICom.generate`` of a 2-frame video prompt with
  ``HICOM_RING_PREFILL_MIN=1``, which routes it to the ring prefill on more
  than one rank: the same 6 ids on every rank as JAX's routed ``generate``
  and as the port's ``generate`` in one process, which does not route.

(The cases of ``tests/test_parallel.py``'s ring tests.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ranks as R
from hicom_tpu.api import HICom as JHICom
from hicom_tpu.config import tiny_test_config
from hicom_tpu.models.hicom import HIComModel
from hicom_tpu.models.qwen2 import KVCache
from hicom_tpu.ops.attention import sdpa as jsdpa
from hicom_tpu.parallel import create_mesh
from hicom_tpu.parallel.ring import ring_prefill, ring_self_attention
from hicom_tpu_torch.weights import state_dict_from_jax

WORLDS = (2, 4)
CASES = {"causal_lens": dict(is_causal=True, kv_lengths=np.array([100, 128], np.int32)),
         "causal": dict(is_causal=True),
         "lens": dict(is_causal=False, kv_lengths=np.array([100, 128], np.int32))}
S, CACHE_LEN = 21, 32


@pytest.fixture(scope="module")
def jax_refs(monkeypatch_module):
    rng = np.random.default_rng(7)
    b, H, KVH, L, d = 2, 4, 2, 128, 16
    qkv = tuple(rng.standard_normal(s).astype(np.float32) for s in ((b, H, L, d), (b, KVH, L, d), (b, KVH, L, d)))
    mesh = create_mesh(dp=8)
    attention = {}
    for case, kw in CASES.items():
        jkw = {k: jnp.asarray(v) if k == "kv_lengths" else v for k, v in kw.items()}
        with mesh:
            attention[case] = np.asarray(jax.jit(
                lambda q, k, v, kw=jkw: ring_self_attention(q, k, v, mesh, axis="dp", **kw))(*map(jnp.asarray, qkv)))
        np.testing.assert_allclose(attention[case], np.asarray(jsdpa(*map(jnp.asarray, qkv), implementation="einsum",
                                                                     **jkw)), rtol=2e-5, atol=2e-5)

    cfg = tiny_test_config()
    model = HIComModel(config=cfg)
    ids = rng.integers(5, cfg.text_config.vocab_size, (1, 10))
    ids[:, 1] = -201
    img = cfg.vision_config.image_size
    frames = rng.standard_normal((1, 2, 3, img, img)).astype(np.float32)
    params = jax.jit(lambda r: model.init(r, jnp.asarray(ids), jnp.asarray(frames), modal="video"))(
        jax.random.PRNGKey(0))["params"]
    tc = cfg.text_config
    embeds = rng.standard_normal((1, S, tc.hidden_size)).astype(np.float32) * 0.1
    positions = np.arange(S, dtype=np.int32)[None]
    last, cache = ring_prefill(model, params, jnp.asarray(embeds), jnp.asarray(positions), mesh, "dp",
                              cache_len=CACHE_LEN)
    monkeypatch_module.setenv("HICOM_RING_PREFILL_MIN", "1")
    jids = JHICom(config=cfg, model=model, params=params, eos_token_id=2, cache_len=64).generate(
        ids, frames=frames, modal="video", max_new_tokens=6)
    monkeypatch_module.delenv("HICOM_RING_PREFILL_MIN")
    payload = dict(qkv=qkv, cases=CASES, state_dict=state_dict_from_jax(jax.device_get(params)), embeds=embeds,
                   positions=positions, cache_len=CACHE_LEN, ids=ids, frames=frames)
    prefill = dict(last=np.asarray(last), k=np.asarray(cache.k), v=np.asarray(cache.v),
                   length=np.asarray(cache.length), valid=np.asarray(cache.valid))
    assert isinstance(cache, KVCache)
    return payload, attention, prefill, np.asarray(jids)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def port(jax_refs, tmp_path_factory):
    root = tmp_path_factory.mktemp("ring")
    torch.save(jax_refs[0], root / "payload.pt")
    out = {}
    for world in WORLDS:
        R.spawn(R.ring_worker, world, str(root / "payload.pt"), str(root / f"w{world}"))
        out[world] = [R.load(root / f"w{world}.{r}") for r in range(world)]
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_ring_attention_matches_jax_and_sdpa(jax_refs, port, case, world):
    from hicom_tpu_torch.ops.attention import sdpa

    payload, attention = jax_refs[0], jax_refs[1]
    kw = {k: torch.as_tensor(v) if k == "kv_lengths" else v for k, v in CASES[case].items()}
    ref = sdpa(*(torch.from_numpy(x) for x in payload["qkv"]), **kw).numpy()
    for rank, res in enumerate(port[world]):
        got = res["attention"][case].numpy()
        np.testing.assert_allclose(got, attention[case], rtol=2e-5, atol=2e-5, err_msg=f"rank {rank} vs JAX")
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5, err_msg=f"rank {rank} vs sdpa")


@pytest.mark.parametrize("world", WORLDS)
def test_ring_prefill_matches_jax(jax_refs, port, world):
    want = jax_refs[2]
    for rank, res in enumerate(port[world]):
        got = res["prefill"]
        np.testing.assert_allclose(got["last"][:, 0].numpy(), want["last"][:, 0], rtol=2e-5, atol=2e-5)
        for key in ("k", "v"):
            assert got[key].shape[3] == CACHE_LEN
            np.testing.assert_allclose(got[key][:, :, :, :S].numpy(), want[key][:, :, :, :S], rtol=2e-5, atol=2e-5,
                                       err_msg=f"rank {rank} cache {key}")
        assert got["length"] == S == int(want["length"][0])
        np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
        np.testing.assert_array_equal(got["valid"].numpy(), np.arange(CACHE_LEN)[None] < S)


@pytest.mark.parametrize("world", WORLDS)
def test_generate_routes_to_the_ring_prefill(jax_refs, port, world):
    """Every rank took the ring route once and emitted JAX's routed ids, which
    the port's one-process ``generate`` (no route: one rank) emits too."""
    from hicom_tpu_torch.api import HICom

    payload, jids = jax_refs[0], jax_refs[3]
    model = R._tiny_model({}, payload["state_dict"])
    one = HICom(config=model.hicom_config, model=model, eos_token_id=2, cache_len=64).generate(
        payload["ids"], frames=payload["frames"], modal="video", max_new_tokens=6)
    np.testing.assert_array_equal(one, jids)
    for res in port[world]:
        assert res["ring_calls"] == 1 and res["no_jax"]
        np.testing.assert_array_equal(res["ids"], jids)
