"""The fp32 forward kernels and the new head dims against the JAX package on the CPU.

The port's fp32 instances (``csrc/flash_fwd_f32.cu`` for K1/K2, the fp32
merge, K4's fp32 form) compute what their plain twins compute in fp32. Here
the twins are held to the Pallas kernels in interpret mode on inputs from a
numpy seed, in fp32 and at the head dims that now have kernels (16, 96):

* K1 (``_fullblock_fwd``) at d 16, 72 and 96 over 200 and 729 keys, and K2
  at d 96 with full blocks (causal, lengths) and at d 128 grouped, and K4 on
  the video tile: ``TOL``, 2e-5 absolute and relative, the tolerance of
  ``tests/test_torch_ops.py`` (the same fp32 arithmetic summed in another
  order);
* the split forward and its merge at the global compressor's 32 queries over
  2,916 keys, d 128: rtol 1e-5 (atol 1e-6 for elements near zero), which a
  bf16 step in the merged rows (2^-9 relative) fails, as the test shows;
* a tiny fp32 HICom (tower head dim 16 over a 12 x 12 patch grid, a
  non-grouped decoder of 2 heads of 96) built in JAX and carried over by
  ``state_dict_from_jax``: logits within 1e-4 (the decoder tests' tolerance)
  and equal greedy ids; then the same configuration on meta tensors through
  the wrappers' device branch, launches stubbed as in
  ``tests/test_torch_kernel_routes.py``: K1, K2 and K4 launch and nothing
  raises;
* the same tiny fp32 HICom trained one stage-2 step (``mm_projector``, the
  direct guide): the loss and every trained parameter's gradient against
  ``jax.value_and_grad`` of JAX's loss, on the port's CPU path and with the
  card's routes taken on the CPU (``sdpa`` sending what JAX's rule sends to
  Pallas through ``run_kernel``, so the decoder's d-96 prefill and the
  global compressor train through ``FlashAttention`` and the K5/K6 twin):
  the loss within rtol 1e-5 and each gradient within ``GRAD_TOL`` (the
  train tests' 1e-4 of the grad norm, per element: the same fp32 arithmetic
  through 2 tower, 2 guide and 2 decoder layers in another order); then its
  backward on meta tensors through the wrappers' device branch: K5/K6 launch
  ``flash_bwd_f32.cu``'s instances, once per decoder layer and once for the
  global compressor, and a bf16 copy launches ``flash_bwd.cu``'s.

Then the fp32 gate of ``chip_smoke.py`` (``agreement`` with ``FP32_GATE``) at a
cut so400m shape: the fp32 twin passes against float64, the same twin on
operands rounded to TF32 or to bf16 fails. One torch thread (the test
workers share the machine's cores).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hicom_tpu import config as jcfg
from hicom_tpu.models.generate import generate_tokens as j_generate
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu.train import train_step as jstep
from hicom_tpu.ops import flash_attention as jfa
from hicom_tpu.ops.local_attn import fused_tile_attention as j_fused_tile
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models.generate import generate_tokens as t_generate
from hicom_tpu_torch.models import projector as tprojector
from hicom_tpu_torch.models import qwen2 as tqwen2
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.ops import attention as tattn
from hicom_tpu_torch.ops import flash_attention as tfa
from hicom_tpu_torch.ops import flash_decode as tfd
from hicom_tpu_torch.ops import local_attn as tla
from hicom_tpu_torch.ops.cuda_build import plain_route
from hicom_tpu_torch.train import optimizer as topt
from hicom_tpu_torch.train import train_step as tstep
from hicom_tpu_torch.weights import state_dict_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_torch_ops.py
MERGE_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_decoder.py
# each gradient element within 1e-4 of its value plus 1e-4 of its tensor's largest |value| (floored at 1e-6 of
# the largest over the trained tensors: the keys' bias, whose exact gradient the softmax cancels, is fp32 noise)
GRAD_TOL = 1e-4
VIDEO, IGNORE = -201, -100


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _valid(x, lens, L):
    if not lens:
        return np.asarray(x)
    return np.where((np.arange(L)[None, :] < np.asarray(lens)[:, None])[:, None, :, None], np.asarray(x), 0)


# --------------------------------------------------------------------------- #
# the kernels' twins against the Pallas kernels, in fp32
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("L", [200, 729])
@pytest.mark.parametrize("d", [16, 72, 96])
def test_k1_fp32_twin_matches_pallas(d, L):
    rng = np.random.default_rng(d * 1000 + L)
    q, k, v = (_rand(rng, 2, L, d) for _ in range(3))
    ref, ref_lse = jfa._fullblock_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d**-0.5, 0.25, True)
    got, got_lse = tfa.fullblock_attention(*_t(q, k, v), d**-0.5, 0.25)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(ref_lse), rtol=1e-4, atol=1e-4)  # a log of L terms


def test_k2_fp32_d96_full_blocks_matches_pallas():
    # d 96 is no multiple of 64: JAX's rule takes the flash kernel only with whole-sequence blocks
    rng = np.random.default_rng(96)
    b, H, L, d, lens = 2, 2, 300, 96, [217, 300]
    q, k, v = (_rand(rng, b, H, L, d) for _ in range(3))
    kw = dict(is_causal=True, block_q=1024, block_k=1024)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), kv_lengths=jnp.asarray(lens, jnp.int32), interpret=True,
                              **kw)
    got = tfa.flash_attention(*_t(q, k, v), kv_lengths=torch.tensor(lens, dtype=torch.int32), **kw)
    np.testing.assert_allclose(_valid(got.numpy(), lens, L), _valid(ref, lens, L), **TOL)
    assert tattn.flash_route(q.shape, k.shape, is_causal=True, kv_lengths=lens) == "flash"


def test_k2_fp32_d128_gqa_matches_pallas():
    rng = np.random.default_rng(128)
    b, KVH, g, L, d, lens = 2, 2, 3, 241, 128, [200, 241]
    q, k, v = _rand(rng, b, KVH * g, L, d), _rand(rng, b, KVH, L, d), _rand(rng, b, KVH, L, d)
    ref = jfa.flash_attention_gqa(*map(jnp.asarray, (q, k, v)), is_causal=True,
                                  kv_lengths=jnp.asarray(lens, jnp.int32), block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention_gqa(*_t(q, k, v), is_causal=True, kv_lengths=torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(_valid(got.numpy(), lens, L), _valid(ref, lens, L), **TOL)


def test_split_forward_and_merge_fp32_global_shape():
    """The global compressor's split path in fp32: 32 queries over 2,916
    keys, d 128, in the kernel's chunks (29, as at 9 heads and b 1) and
    through the split-key route (partials, then ``merge_partials``), both
    within rtol 1e-5 of the Pallas kernel; the same rows through a bf16 step
    fail that tolerance."""
    rng = np.random.default_rng(2916)
    b, H, Lq, Lk, d = 1, 2, 32, 2916, 128
    q, k, v = _rand(rng, b, H, Lq, d), _rand(rng, b, H, Lk, d), _rand(rng, b, H, Lk, d)
    ref = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    n_split = tfa.forward_splits(1, 9, Lq, Lk, d=d)
    assert n_split == 29
    out, _ = tfa.split_forward_reference(*_t(q, k, v), None, d**-0.5, 0.0, False, n_split)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **MERGE_TOL)
    routed = tattn.sdpa(*_t(q, k, v), kv_group=tattn.SoloGroup())
    assert routed.dtype == torch.float32
    np.testing.assert_allclose(routed.numpy(), ref, **MERGE_TOL)
    rounded = out.bfloat16().float().numpy()
    assert not np.allclose(rounded, ref, **MERGE_TOL)


def test_k4_fp32_twins_match_pallas():
    rng = np.random.default_rng(27)
    key, val, q = _rand(rng, 8, 27, 27, 64), _rand(rng, 8, 27, 27, 64), _rand(rng, 2, 9, 9, 64)
    ref = np.asarray(j_fused_tile(*map(jnp.asarray, (q, key, val)), (4, 3, 3), np.float32(0.125), np.float32(0.1),
                                  interpret=True))
    for fn in (tla.fused_tile_attention, tla.tile_reference, tla.chunked_tile_reference):
        got = fn(*_t(q, key, val), (4, 3, 3), 0.125, 0.1)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


# --------------------------------------------------------------------------- #
# the slice: a tiny fp32 HICom at the new head dims
# --------------------------------------------------------------------------- #

def _configs():
    """Tower head dim 16 (64 wide, 4 heads) over 168 x 168 frames (12 x 12
    patches: 144 tokens, enough for JAX's rule to pick K1), a non-grouped
    decoder of 2 heads of 96."""
    out = []
    for mod in (jcfg, tcfg):
        c = mod.tiny_test_config(use_guide="direct", dtype="float32")
        out.append(c.replace(text_config=dataclasses.replace(c.text_config, hidden_size=192, num_attention_heads=2,
                                                             num_key_value_heads=2, head_dim=96),
                             vision_config=dataclasses.replace(c.vision_config, image_size=168)))
    return out


def _request(seed, L=120):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, (1, L))
    ids[0, 2] = VIDEO
    return ids, rng.standard_normal((1, 4, 3, 168, 168)).astype(np.float32), rng.integers(1, 250, (1, 16))


@pytest.fixture(scope="module")
def pair():
    cj, ct = _configs()
    ids, frames, gids = _request(0)
    jm = JModel(config=cj)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(frames),
                              guide_ids=jnp.asarray(gids))["params"]
    tm = TModel(ct)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(params), ct), strict=True)
    return jm, params, tm.eval()


def test_fp32_slice_at_head_dims_16_and_96_matches_jax(pair):
    jm, params, tm = pair
    ids, frames, gids = _request(1)
    ref, _, _ = jax.jit(lambda p, i, f, g: jm.apply({"params": p}, i, f, guide_ids=g))(
        params, jnp.asarray(ids), jnp.asarray(frames), jnp.asarray(gids))
    with torch.no_grad():
        got, _, _ = tm.one_shot_forward(*_t(ids, frames), guide_ids=torch.from_numpy(gids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGIT_TOL)
    kw = dict(modal="video", max_new_tokens=8, eos_token_id=-1, cache_len=256)
    want = j_generate({"params": params}, jnp.asarray(ids), jnp.asarray(frames), jnp.asarray(gids), None,
                      jax.random.PRNGKey(0), None, model=jm, **kw)
    got_ids = t_generate(tm, *_t(ids, frames), torch.from_numpy(gids), None, None, **kw)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want))


def test_fp32_slice_launches_the_kernels_on_the_device_branch(monkeypatch):
    """The same configuration on meta tensors: the tower's attention (144
    tokens, d 16) and the global compressor take K1, the local compressor K4,
    the decoder prefill (d 96, causal) K2; nothing raises."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for mod in (tfa, tfd, tla):
        monkeypatch.setattr(mod, "c_function", lambda *a, **k: (lambda *args: 0))
    for mod in (tfa, tla):
        monkeypatch.setattr(mod, "_sm_count", lambda index: 132)
    wrappers = (tfa.fullblock_attention, tfa.flash_forward, tla.fused_tile_attention)
    before = [f.launches for f in wrappers]
    plain_route.reset()
    _, ct = _configs()
    with torch.device("meta"):
        tm = TModel(ct)
    dev = dict(device="meta")
    b, L = 1, 150
    with torch.inference_mode():
        ge = tm.encode_guide(torch.zeros((b, 16), dtype=torch.long, **dev))
        vis = tm.encode_visual(torch.empty((b, 4, 3, 168, 168), **dev), ge, "video")
        assert vis.dtype == torch.float32
        hidden = tm.model(torch.empty((b, L, 192), **dev), torch.arange(L, **dev)[None],
                          padding_mask=torch.ones((b, L), dtype=torch.bool, **dev))
    assert hidden.shape == (b, L, 192)
    k1, k2, k4 = (f.launches - n for f, n in zip(wrappers, before))
    # K1: each tower layer, and the global compressor (32 queries over 4 x 12 x 12 keys fit one block)
    assert (k1, k2, k4) == (ct.vision_config.num_hidden_layers + 1, ct.text_config.num_hidden_layers, 1)
    assert plain_route.counts["K3"] == 0


# --------------------------------------------------------------------------- #
# the slice: one fp32 stage-2 step of the tiny HICom
# --------------------------------------------------------------------------- #

def _train_batch(seed=3, L=120):
    """b = 2 rows of ``L`` ids with a <video> sentinel (167 spliced tokens: the
    decoder prefill takes K2 on the card), the second right-padded from 100;
    the first 8 labels and the padding ignored; 4 frames of 168 x 168; guide ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, (2, L))
    ids[:, 2] = VIDEO
    mask = np.ones((2, L), bool)
    mask[1, 100:] = False
    ids[1, 100:] = 0
    labels = np.where(mask, ids, IGNORE)
    labels[:, :8] = IGNORE
    return dict(input_ids=ids, attention_mask=mask, labels=labels,
                frames=rng.standard_normal((2, 4, 3, 168, 168)).astype(np.float32),
                guide_ids=rng.integers(1, 250, (2, 16)))


def _card_routes_on_the_cpu(monkeypatch):
    """Make ``sdpa`` take, for CPU tensors too, the route the card takes: what
    JAX's rule sends to Pallas goes through ``run_kernel`` (``FlashAttention``
    with the twins under a gradient). Returns the routed calls as (kernel,
    head dim, whether a gradient was wanted)."""
    real, calls = tattn.sdpa, []

    def routed(q, k, v, *, scale=None, logit_bias=0.0, mask=None, is_causal=False, kv_lengths=None, kv_group=None):
        kernel = kv_group is None and tattn.flash_route(q.shape, k.shape, mask=mask, scale=scale,
                                                         logit_bias=logit_bias, is_causal=is_causal,
                                                         kv_lengths=kv_lengths)
        if not kernel:
            return real(q, k, v, scale=scale, logit_bias=logit_bias, mask=mask, is_causal=is_causal,
                        kv_lengths=kv_lengths, kv_group=kv_group)
        calls.append((kernel, q.shape[-1], torch.is_grad_enabled() and q.requires_grad))
        return tfa.run_kernel(kernel, q, k, v, scale=float(scale) if scale is not None else q.shape[-1] ** -0.5,
                              logit_bias=float(logit_bias), is_causal=is_causal, kv_lengths=kv_lengths)

    for mod in (tattn, tqwen2, tprojector):
        monkeypatch.setattr(mod, "sdpa", routed)
    return calls


@pytest.fixture(scope="module")
def jax_step_grads(pair):
    """JAX's stage-2 loss and gradients at the pair's parameters, in the port's names."""
    jm, params, _ = pair
    loss_fn = jstep.make_loss_fn(jm, tunable_parts="mm_projector", use_guide="direct")
    batch = {k: jnp.asarray(v) for k, v in _train_batch().items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    return float(loss), state_dict_from_jax(jax.device_get(grads), _configs()[1])


@pytest.mark.parametrize("route", ["cpu", "card"])
def test_fp32_stage2_step_matches_jax(pair, jax_step_grads, route, monkeypatch):
    _, _, tm = pair
    want_loss, want = jax_step_grads
    calls = _card_routes_on_the_cpu(monkeypatch) if route == "card" else []
    twin_calls = []
    real_twin = tfa.flash_backward_reference
    monkeypatch.setattr(tfa, "flash_backward_reference", lambda *a: twin_calls.append(1) or real_twin(*a))
    trained = [n for n, p in tm.named_parameters() if topt.is_tunable(n, "mm_projector", "direct")]
    tm.train()
    try:
        for n, p in tm.named_parameters():
            p.requires_grad_(n in trained)
            p.grad = None
        batch = tstep.batch_to_device(_train_batch(), torch.device("cpu"), torch.float32)
        loss, metrics = tstep.make_loss_fn(tm)(batch)
        loss.backward()
        # a parameter the loss does not reach (the direct guide's learned query) has JAX's zero gradient
        got = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in tm.named_parameters()
               if n in trained}
    finally:
        for p in tm.parameters():
            p.requires_grad_(False)
            p.grad = None
        tm.eval()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert len(got) == len(trained) > 0
    top = max(float(want[n].abs().max()) for n in got)
    for n, g in got.items():
        ref = want[n].numpy()
        atol = GRAD_TOL * max(float(np.abs(ref).max()), 1e-6 * top)
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_TOL, atol=atol, err_msg=n)
    if route == "card":  # the global compressor (K1's route, d 64) and the 2 decoder prefills (K2, d 96)
        assert [c[:2] for c in calls if c[2]] == [("fullblock", 64), ("flash", 96), ("flash", 96)], calls
        assert len(twin_calls) == 3
    else:
        assert not twin_calls


@pytest.mark.parametrize("dtype,symbol", [(torch.float32, "_f32"), (torch.bfloat16, "")])
def test_fp32_step_backward_launches_k5_k6_on_the_device_branch(monkeypatch, dtype, symbol):
    """The stage-2 step's backward on meta tensors: each decoder layer (d 96,
    causal) and the global compressor (32 queries over 4 x 12 x 12 keys) run
    K5/K6 once, through ``flash_bwd_f32.cu`` in fp32 and ``flash_bwd.cu`` in
    bf16; K4 takes no gradient (the plain tile attention), nothing raises."""
    symbols = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for mod in (tfa, tfd, tla):
        monkeypatch.setattr(mod, "c_function", lambda name, sym, *a, **k: symbols.append(sym) or (lambda *args: 0))
    for mod in (tfa, tla):
        monkeypatch.setattr(mod, "_sm_count", lambda index: 132)
    _, ct = _configs()
    ct = ct.replace(dtype="float32" if dtype == torch.float32 else "bfloat16")
    with torch.device("meta"):
        tm = TModel(ct)
    for n, p in tm.named_parameters():
        p.requires_grad_(topt.is_tunable(n, "mm_projector", "direct"))
    before = tfa.flash_backward.launches, tla.fused_tile_attention.launches
    dev = dict(device="meta")
    b, L = 1, 150
    ge = tm.encode_guide(torch.zeros((b, 16), dtype=torch.long, **dev))
    vis = tm.encode_visual(torch.empty((b, 4, 3, 168, 168), dtype=dtype, **dev), ge, "video")
    emb = torch.cat([vis.reshape(b, -1, vis.shape[-1]), torch.empty((b, L - 48, 192), dtype=dtype, **dev)], dim=1)
    hidden = tm.model(emb, torch.arange(L, **dev)[None], padding_mask=torch.ones((b, L), dtype=torch.bool, **dev))
    assert vis.requires_grad and hidden.dtype == dtype
    hidden.backward(torch.empty_like(hidden))
    launched = tfa.flash_backward.launches - before[0]
    assert launched == ct.text_config.num_hidden_layers + 1 and tla.fused_tile_attention.launches == before[1]
    bwd = [s for s in symbols if "bwd" in s]
    assert bwd == [f"hicom_flash_bwd_{k}{symbol}" for _ in range(launched) for k in ("dq", "dkv")]
    assert plain_route.counts["K3"] == 0


# --------------------------------------------------------------------------- #
# the fp32 gate
# --------------------------------------------------------------------------- #

def _round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """fp32 values rounded to nearest on a ``bits``-bit mantissa (10: TF32, 7: bf16)."""
    shift = 23 - bits
    i = x.view(torch.int32)
    half = 1 << (shift - 1)
    i = (i + half + ((i >> shift) & 1) - 1) & ~((1 << shift) - 1)
    return i.view(torch.float32)


def test_fp32_gate_separates_fp32_from_tf32_and_bf16():
    """At a cut so400m shape (4 rows of 729 x 729, d 72), against float64:
    the fp32 twin passes the fp32 gate; the same twin on operands rounded to
    TF32 (10-bit mantissa) or to bf16 fails it."""
    rng = np.random.default_rng(72)
    q, k, v = (torch.from_numpy(_rand(rng, 4, 1, 729, 72)) for _ in range(3))
    twin = lambda a, b_, c: tfa.flash_reference(a, b_, c, None, 72**-0.5, 0.0, False)[0]  # noqa: E731
    exact = twin(q.double(), k.double(), v.double())
    ratio = lambda got: chip_smoke.agreement(got, exact, chip_smoke.FP32_GATE)[1]  # noqa: E731
    assert ratio(twin(q, k, v)) <= 1
    for bits in (10, 7):
        rounded = [_round_mantissa(x, bits) for x in (q, k, v)]
        assert 0 < (rounded[0] - q).abs().max() <= 2.0 ** -bits * q.abs().max()
        assert ratio(twin(*rounded)) > 1, bits
