"""The port's bench (``hicom_tpu_torch/bench.py``) against the JAX bench
(``bench.py``): the same FLOP model, the same arm pipeline and decode step
on the same weights and inputs. Every mode's CPU sanity run is in
``tests/test_torch_bench_modes.py``.

The FLOP model is compared exactly. The pipeline's scalar (the sum of the
last token's logits) and one decode step's logits are compared in fp32 at
rtol 1e-4 (measured: 7.8e-7 and 1.9e-7 for the video and image scalars;
3.4e-7 of the largest logit with a float cache, 5.3e-7 with an int8 cache,
whose codes both packages round alike, so it takes the same tolerance); the
decode step also in bf16, the bench's dtype, within two bf16 ulps of the
largest logit.
"""

import contextlib
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from hicom_tpu import config as jcfg
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu.models.qwen2 import KVCache as JCache
from hicom_tpu_torch import bench as tb
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.weights import state_dict_from_jax

TOWER_QUANTS = ("none", "w8a8", "w8a8_mlp", "w8a8_mlp_qkv", "w8a8s", "w8a8s_mlp", "w8a8s_mlp_qkv")
DEC_QUANTS = ("none", "int8", "w8a8", "w8a8_mlp", "w8a8s", "w8a8s_mlp")
H100 = tb.PEAKS[""]


@contextlib.contextmanager
def one_thread():
    """The port on one CPU thread: the test workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


# --------------------------------------------------------------------------- #
# The FLOP and byte models
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("model", ["1.5b", "7b"])
@pytest.mark.parametrize("shape", ["video32", "video64", "image", "small"])
def test_flop_model_equals_the_jax_bench(model, shape, monkeypatch):
    frames = 64 if shape == "video64" else 32
    b, t = {"video32": (4, 32), "video64": (4, 64), "image": (32, 1), "small": (4, 4)}[shape]
    small = shape == "small"
    jc = bench.serving_config(model, frames=frames)
    pc = tb.serving_config(model, frames=frames)
    assert pc.text_config.quantization == jc.text_config.quantization == ("int8" if model == "7b" else None)
    comp, S = tb.flops_components(pc, b, t, 48, small)
    jcomp, jS = bench.flops_components(jc, b, t, 48, small)
    assert (comp, S) == (jcomp, jS)
    # the JAX bench's ceilings set to the H100's: the tower's attention at the bf16 peak
    monkeypatch.setattr(bench, "INT8_CEILING_TOPS", H100.int8 / 1e12)
    monkeypatch.setattr(bench, "VIS_ATTN_TFLOPS", H100.bf16 / 1e12)
    for tq in TOWER_QUANTS:
        for dq in DEC_QUANTS:
            int8 = tb.int8_executed_flops(comp, tq, dq)
            assert int8 == bench.int8_executed_flops(jcomp, tq, dq), (tq, dq)
            assert tb.vs_baseline_cap(comp, int8, H100) == bench.vs_baseline_cap(jcomp, int8, H100.bf16 / 1e12)
            assert tb.matched_mfu_pct(sum(comp.values()), int8, 0.37, H100) == bench.matched_mfu_pct(
                sum(jcomp.values()), int8, 0.37, H100.bf16 / 1e12)
    # the train step: the tower once (frozen), the decoder and head twice (stage 1) or thrice
    spliced = 48 - 1 + (36 if small else 680)
    tc = pc.text_config
    dcomp, dS = tb.flops_components(pc, b, 32, 48, small)  # the train step's 680 visual tokens
    assert dS == spliced
    head = 2 * tc.vocab_size * tc.hidden_size * spliced * b
    vis = sum(comp[k] for k in ("vis_qkv", "vis_out", "vis_mlp", "vis_attn"))
    dec = sum(dcomp[k] for k in ("dec_qkvo", "dec_mlp", "dec_attn"))
    for parts, mult in (("mm_projector", 2), ("mm_projector,language_model", 3)):
        assert tb.train_flops(pc, b, t, 48, parts, small) == (vis + mult * (dec + head), spliced)


@pytest.mark.parametrize("model", ["1.5b", "7b"])
def test_decode_weight_bytes_are_the_linears_and_the_head(model):
    cfg = tb.serving_config(model)
    with torch.device("meta"):
        m = TModel(cfg)
    linears = sum(t.numel() * t.element_size() for n, t in m.model.layers.state_dict().items()
                  if n.endswith(("proj.weight", "proj.weight_q")))
    assert tb.decode_weight_bytes(cfg.text_config) == linears + m.lm_head.weight.numel() * 2
    if model == "1.5b":  # 3.09 GB: the b = 1 floor at 3.35 TB/s is 1,085 tokens/s
        assert round(H100.hbm / tb.decode_weight_bytes(cfg.text_config)) == 1085


def test_card_peaks_by_name():
    assert tb.card_peaks("NVIDIA H100 80GB HBM3") == H100 == (989e12, 1979e12, 3.35e12)
    assert tb.card_peaks("NVIDIA H100 PCIe").bf16 == 756e12
    assert tb.card_peaks("NVIDIA H100 NVL").hbm == 3.9e12


# --------------------------------------------------------------------------- #
# The arm pipeline and the decode step against JAX
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def pair():
    """The tiny direct-guide model in fp32: JAX's parameters and the port's model on them."""
    cj = jcfg.tiny_test_config(use_guide="direct")
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 500, (1, 10))
    ids[0, 2] = -201
    jm = JModel(config=cj)
    params = jax.jit(lambda r: jm.init(r, jnp.asarray(ids), jnp.zeros((1, 4, 3, 56, 56)),
                                       guide_ids=jnp.ones((1, 16), jnp.int32))["params"])(jax.random.PRNGKey(0))
    params = jax.device_get(params)
    tm = TModel(tcfg.tiny_test_config(use_guide="direct"))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, tm.eval()


@pytest.mark.parametrize("modal", ["video", "image"])
def test_arm_pipeline_matches_the_jax_bench(pair, modal, monkeypatch):
    """``bench._make_arm``'s own jitted pipeline (its ``run``) on the tiny
    config in fp32 with the fixture's weights, against the port's
    ``prefill_scalar`` on the same inputs; the port's ``arm_inputs`` draws
    the JAX bench's ids and guide ids, and its frames before the bf16 cast."""
    import hicom_tpu.config

    params, tm = pair
    tiny = hicom_tpu.config.tiny_test_config
    monkeypatch.setattr(hicom_tpu.config, "tiny_test_config", lambda **kw: tiny(**{**kw, "dtype": "float32"}))
    monkeypatch.setattr(bench, "random_params_like", lambda shapes, float_dtype=None: params)
    args = SimpleNamespace(small=True, batch=2, modal=modal, frames=32, model="1.5b")
    fn, inputs, cfg, b, t = bench._make_arm(args, "none", "none")
    ref = float(fn(*inputs))
    _, ids, frames, gids = (np.asarray(x) for x in inputs)
    sentinel = -200 if modal == "image" else -201
    pids, pframes, pgids = tb.arm_inputs(tb.tiny_test_config(use_guide="direct"), b, t, sentinel)
    np.testing.assert_array_equal(pids, ids)
    np.testing.assert_array_equal(pgids, gids)
    np.testing.assert_array_equal(torch.from_numpy(pframes).bfloat16().float().numpy(), frames.astype(np.float32))
    with one_thread():
        got = tb.prefill_scalar(tm, torch.from_numpy(ids), torch.from_numpy(frames.astype(np.float32)),
                                torch.from_numpy(gids), modal).item()
    assert got == pytest.approx(ref, rel=1e-4)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(pair, dtype, kv_int8):
    """One step in the JAX bench's cache set-up (``bench.py:654-662``): a
    zero cache of 128 slots, the first 64 valid, the write offset at 64, in
    the model's dtype. fp32 at rtol 1e-4; bf16 (the bench's, both packages
    on the same bf16-rounded weights) within two bf16 ulps of the largest
    logit (measured: 1.3 ulps) and the same argmax."""
    params, tm = pair
    b, cache_len, valid = 2, 128, 64
    cj = jcfg.tiny_test_config(use_guide="direct", dtype=dtype)
    cj = cj.replace(text_config=dataclasses.replace(cj.text_config, kv_cache_int8=kv_int8))
    tc = cj.text_config
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if dtype == "bfloat16":
        params = jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
                                        if x.dtype == np.float32 else x, params)
        tm = TModel(tcfg.tiny_test_config(use_guide="direct", dtype=dtype))
        tm.load_state_dict({k: v.to(tdt) if v.is_floating_point() else v
                            for k, v in state_dict_from_jax(params).items()}, strict=True)
        tm.eval()
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((b, 1, tc.hidden_size)).astype(np.float32)
    pos = np.full((b, 1), valid)
    cache = JCache.zeros(tc.num_hidden_layers, b, tc.num_key_value_heads, cache_len, tc.head_dim, jdt,
                         quantized=kv_int8)
    cache = cache._replace(length=jnp.full((b,), valid, jnp.int32),
                           valid=jnp.broadcast_to(jnp.arange(cache_len)[None, :] < valid, (b, cache_len)))
    jm = JModel(config=cj)

    def run(m):
        hidden, _ = m.language_model.model(jnp.asarray(emb, jdt), jnp.asarray(pos, jnp.int32), cache)
        return m.language_model.logits(hidden)

    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt) if x.dtype == np.float32 else x, params)
    ref = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, method=run))(jparams).astype(jnp.float32))
    pcache = tb.decode_cache(dataclasses.replace(tm.config, kv_cache_int8=kv_int8), b, cache_len, "cpu", tdt)
    assert (pcache.length, int(pcache.valid.sum())) == (valid, b * valid)
    with one_thread():
        got = tb.decode_step(tm, torch.from_numpy(emb).to(tdt), pcache, torch.from_numpy(pos)).float().numpy()
    top = np.abs(ref).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * top)
    else:
        assert np.abs(got - ref).max() <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    assert pcache.length == valid + 1 and bool(pcache.valid[:, valid].all())
