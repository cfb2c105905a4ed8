"""The port's continuous-batching ``ServeEngine`` against JAX's, on the CPU.

``tests/test_serve.py``'s cases without the mesh one: the same tiny model (its
weights carried by ``state_dict_from_jax``, fp32), the same requests and engine
settings, through the JAX package's ``ServeEngine`` and the port's
(``device="cpu"``: every round eager). Greedy streams must equal JAX's
exactly and equal the port's one-shot ``generate_tokens`` of each request
alone (slots are independent, bucket padding is invisible, a reused slot keeps
no residue); the speculative engine and its adaptive policy must give the same
streams and the same ``spec_rounds`` / ``plain_rounds`` as JAX's. Sampled
streams are held to their structure only (the random generators differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu.serve import GenRequest as JRequest
from hicom_tpu.serve import ServeEngine as JEngine
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models.generate import generate_tokens
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.serve import GenRequest, ServeEngine
from hicom_tpu_torch.weights import state_dict_from_jax

VIDEO = -201
EOS = 2


@pytest.fixture(scope="module")
def setup():
    """``tests/test_serve.py``'s model and variables, and the port's model on its weights."""
    cfg = jcfg.tiny_test_config()
    jm = JModel(config=cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, cfg.text_config.vocab_size, (1, 10))
    ids[:, 3] = VIDEO
    frames = rng.standard_normal((1, 4, 3, 56, 56)).astype(np.float32)
    params = jax.jit(lambda i, f: jm.init(jax.random.PRNGKey(0), i, f, modal="video"))(
        jnp.asarray(ids), jnp.asarray(frames))["params"]
    ct = tcfg.tiny_test_config()
    tm = TModel(ct)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(params), ct), strict=True)
    return jm, {"params": params}, tm.eval()


def video_request(seed, L=10, max_new=8, stops=()):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 512, (L,))
    ids[3] = VIDEO
    frames = rng.standard_normal((4, 3, 56, 56)).astype(np.float32)
    return dict(input_ids=ids.astype(np.int32), frames=frames, modal="video", max_new_tokens=max_new,
                stop_sequences=stops)


def text_request(seed, L=7, max_new=8, stops=()):
    ids = np.random.default_rng(seed).integers(5, 512, (L,)).astype(np.int32)
    return dict(input_ids=ids, modal="text", max_new_tokens=max_new, stop_sequences=stops)


def serve(setup, reqs, **kw):
    """The port's and JAX's engines over the same requests -> (port streams,
    JAX streams, port engine, JAX engine)."""
    jm, variables, tm = setup
    je = JEngine(jm, variables, eos_token_id=EOS, **kw)
    jids = [je.submit(JRequest(**r)) for r in reqs]
    jres = je.run()
    te = ServeEngine(tm, eos_token_id=EOS, device="cpu", **kw)
    tids = [te.submit(GenRequest(**r)) for r in reqs]
    tres = te.run()
    return ([tres[i].tokens.tolist() for i in tids], [jres[i].tokens.tolist() for i in jids], te, je)


def one_shot(setup, req, max_new=8):
    """The port's per-request greedy ``generate_tokens``, trimmed at eos."""
    tm = setup[2]
    frames = req.get("frames")
    out = generate_tokens(tm, torch.from_numpy(req["input_ids"][None].astype(np.int64)),
                          None if frames is None else torch.from_numpy(frames[None]), None, None,
                          modal=req["modal"], max_new_tokens=max_new, eos_token_id=EOS, cache_len=128)[0].tolist()
    return out[:out.index(EOS)] if EOS in out else out


MIXED = [video_request(1, L=10), text_request(2, L=7), video_request(3, L=12), text_request(4, L=5)]


def test_engine_matches_jax_and_one_shot(setup):
    """More requests than slots, mixed modals and buckets, the last admitted
    into a reused slot: every stream equals JAX's engine's and the request's
    own one-shot generate."""
    got, ref, _, _ = serve(setup, MIXED, n_slots=2, cache_len=128, prompt_buckets=(12, 16), sync_steps=3)
    assert got == ref
    assert got == [one_shot(setup, r) for r in MIXED]


@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("stop", ["budget", "keyword"])
def test_budget_and_keyword_stop(setup, stop, spec_k):
    """A budget of 3 truncates mid-round (mid-chunk under speculation); a
    2-token keyword trims the stream before it."""
    base = one_shot(setup, video_request(1))
    assert len(base) >= 3
    if stop == "budget":
        req, want = video_request(1, max_new=3), base[:3]
    else:
        req, want = video_request(1, stops=((base[1], base[2]),)), base[:1]
    got, ref, _, _ = serve(setup, [req], n_slots=1, cache_len=256, prompt_buckets=(12,), sync_steps=4,
                           spec_k=spec_k)
    assert got == ref == [want]


@pytest.mark.parametrize("case", ["prompt", "budget", "spliced_video"])
def test_oversized_request_rejected(setup, case):
    """A prompt past the largest bucket and a budget past the cache are
    refused, as JAX's engine refuses them; so is a video whose spliced
    prompt (bucket - 1 + V slots) cannot fit, which JAX's check, counting the
    bucket alone, lets through."""
    jm, variables, tm = setup
    if case == "spliced_video":
        V = tm.visual_token_count(4, "video")
        cache_len = 12 + 8 + 3 * 1 - 1 + V // 2  # room for the bucket, the budget, a round; not the visual tokens
        req = video_request(1, L=10)
        JEngine(jm, variables, n_slots=1, cache_len=cache_len, prompt_buckets=(12,), sync_steps=3).submit(
            JRequest(**req))
        eng = ServeEngine(tm, n_slots=1, cache_len=cache_len, prompt_buckets=(12,), sync_steps=3, device="cpu")
    else:
        req = text_request(0, L=20) if case == "prompt" else text_request(0, L=8, max_new=100)
        with pytest.raises(ValueError):
            JEngine(jm, variables, n_slots=1, cache_len=64, prompt_buckets=(8,)).submit(JRequest(**req))
        eng = ServeEngine(tm, n_slots=1, cache_len=64, prompt_buckets=(8,), device="cpu")
    with pytest.raises(ValueError):
        eng.submit(GenRequest(**req))


def test_sync_admission_arm_matches_async(setup):
    """The A/B arm that fetches each first token at admission gives the same
    streams as asynchronous admission, and as JAX's engine."""
    reqs = [video_request(1, L=10), text_request(2, L=7), text_request(4, L=5)]
    kw = dict(n_slots=2, cache_len=128, prompt_buckets=(12, 16), sync_steps=3)
    got, ref, _, _ = serve(setup, reqs, **kw)
    tm = setup[2]
    eng = ServeEngine(tm, eos_token_id=EOS, device="cpu", sync_admission=True, **kw)
    ids = [eng.submit(GenRequest(**r)) for r in reqs]
    res = eng.run()
    assert [res[i].tokens.tolist() for i in ids] == got == ref


def test_spec_engine_matches_plain(setup):
    """spec_k = 3 with slot reuse (a fresh history for the reused slot): every
    stream equals the plain greedy one and JAX's speculative engine's, with
    the same round counts."""
    reqs = [video_request(1, L=10, max_new=16), text_request(2, L=7, max_new=16),
            video_request(3, L=12, max_new=16), text_request(4, L=5, max_new=16)]
    got, ref, te, je = serve(setup, reqs, n_slots=2, cache_len=256, prompt_buckets=(12, 16), sync_steps=3, spec_k=3)
    assert got == ref
    assert got == [one_shot(setup, r, max_new=16) for r in reqs]
    assert (te.spec_rounds, te.plain_rounds) == (je.spec_rounds, je.plain_rounds)


def test_spec_requires_greedy(setup):
    with pytest.raises(ValueError):
        ServeEngine(setup[2], spec_k=2, temperature=0.7, device="cpu")


POLICY = {
    # 2 resident slots: plain rounds; the long request's tail alone: spec rounds
    "occupancy_switch": ([text_request(s, L=7, max_new=m) for s, m in ((2, 24), (4, 6), (5, 6))],
                         dict(n_slots=2, spec_max_active=1)),
    # one resident slot at any acceptance: every round speculative
    "single_slot": ([text_request(2, L=7, max_new=12)], dict(n_slots=1, spec_min_accept=0.0)),
    # any measured rate is too low: a probe, 2 plain rounds, a probe, ...
    "cooldown": ([text_request(2, L=7, max_new=24)], dict(n_slots=1, spec_min_accept=1.01, spec_retry_rounds=2)),
    # the always-speculative engine
    "forced_off": ([text_request(s, L=7, max_new=8) for s in (2, 4)], dict(n_slots=2, spec_adaptive=False)),
}


@pytest.mark.parametrize("case", list(POLICY))
def test_spec_policy_matches_jax(setup, case):
    reqs, kw = POLICY[case]
    got, ref, te, je = serve(setup, reqs, cache_len=256, prompt_buckets=(12,), sync_steps=2, spec_k=3, **kw)
    assert got == ref
    assert got == [one_shot(setup, r, max_new=r["max_new_tokens"]) for r in reqs]
    assert (te.spec_rounds, te.plain_rounds) == (je.spec_rounds, je.plain_rounds)
    if je._accept_ema is None:
        assert te._accept_ema is None
    else:
        assert te._accept_ema == pytest.approx(je._accept_ema)
    if case == "occupancy_switch":
        assert te.plain_rounds > 0 and te.spec_rounds > 0
    elif case == "single_slot":
        assert te.spec_rounds > 0 and te.plain_rounds == 0
    elif case == "cooldown":
        assert te.spec_rounds >= 2 and te.plain_rounds >= 2
    else:
        assert te.plain_rounds == 0 and te.spec_rounds > 0


def test_stale_candidates_after_a_spec_round(setup):
    """A spec round leaves unaccepted candidate slots marked valid past a
    slot's offset; the plain rounds of the cooldown that follow must not see
    them. The stream equals JAX's default path and the plain one-shot."""
    req = text_request(2, L=7, max_new=24)
    kw = dict(n_slots=1, cache_len=256, prompt_buckets=(12,), sync_steps=2, spec_k=3, spec_min_accept=1.01,
              spec_retry_rounds=2)
    eng = ServeEngine(setup[2], eos_token_id=EOS, device="cpu", **kw)
    rid = eng.submit(GenRequest(**req))
    eng.step_round()
    assert eng.spec_rounds == 1
    slots = torch.arange(eng.cache_len)
    assert bool((eng.cache.valid[0] & (slots > eng.cache.lengths[0])).any()), "no stale candidate to hide"
    eng.step_round()
    assert eng.plain_rounds == 1
    got = eng.run()[rid].tokens.tolist()
    _, ref, _, _ = serve(setup, [req], **kw)
    assert [got] == ref
    assert got == one_shot(setup, req, max_new=24)


def test_sampled_engine_keeps_its_structure(setup):
    """temperature > 0: streams within budget, without eos, inside the
    vocabulary, and the same from the same seed."""
    reqs = [video_request(1, L=10, max_new=9), text_request(2, L=7, max_new=5), text_request(4, L=5, max_new=7)]

    def run(seed):
        eng = ServeEngine(setup[2], n_slots=2, cache_len=128, prompt_buckets=(12, 16), sync_steps=3,
                          temperature=0.9, top_p=0.8, eos_token_id=EOS, seed=seed, device="cpu")
        ids = [eng.submit(GenRequest(**r)) for r in reqs]
        res = eng.run()
        return [res[i].tokens.tolist() for i in ids]

    a = run(3)
    assert a == run(3)
    for toks, r in zip(a, reqs):
        assert len(toks) <= r["max_new_tokens"] and EOS not in toks
        assert all(0 <= t < 512 for t in toks)


def test_engine_rejects_graphs_on_the_cpu(setup):
    with pytest.raises(ValueError):
        ServeEngine(setup[2], device="cpu", cuda_graphs=True)
