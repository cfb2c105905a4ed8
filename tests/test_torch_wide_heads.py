"""Attention at head dims 136-256 (the kernels' 192 and 256 instances) against the JAX package on the CPU.

JAX's ``auto`` rule sends every head dim that is a multiple of 64 to its Pallas
kernels (192 and 256 at any length), and every multiple of 8 in one block of at
most 1,024 rows (136, 144, ...); the Pallas kernels have no width limit. The
port's kernels pad such a head dim to 192 or 256 (``tfa._padded``). Here the
twins that the kernels are held to on the card run against the Pallas kernels
in interpret mode, on inputs from a numpy seed, in fp32 and bf16:

* the forward: K1 (``_fullblock_fwd``) at d 136, 192 and 256; K2 at d 256
  grouped 7:1, causal with ``kv_lengths`` (the d-256 decoder's heads), at d
  192 grouped 3:1 causal, at d 192 in one non-causal block with lengths, and
  d 136 through ``flash_attention``'s full-block route; the split forward and
  the split-key route's partials + merge at d 256 over 700 keys;
* the backward: the K5/K6 twin and the ``FlashAttention`` Function against
  ``jax.vjp`` of the Pallas backward at d 192 and 256 (and the full-block route
  at d 136 and 256); the split twins against the unsplit twin at d 256;
* a tiny HICom whose decoder has 2 query heads and 1 kv head of 256, carried
  from JAX by ``state_dict_from_jax`` (bf16 on the same bf16-rounded weights):
  greedy ids and last-token logits of one video request, and one stage-2
  step's loss and projector gradients, with the card's routes taken on the
  CPU (``sdpa`` sending what JAX's rule sends to Pallas through
  ``run_kernel``, so the prefill runs the K2 twin and the step the K5/K6
  twin); then the same model on meta tensors through the wrappers' device
  branch: K2 at each decoder layer's prefill, the one-token step on the
  plain route by K3's contract, K5/K6's 256 instance in the backward.

Tolerances: fp32 forward 2e-5 and the merged rows 1e-5 (rtol and atol, those
of ``test_torch_fp32_kernels.py`` and ``test_torch_flash_split.py``: the same
fp32 arithmetic in another summation order), fp32 gradients 5e-5 (those of
``test_torch_flash_bwd.py``, for sums over a few hundred keys). bf16 kernels:
every element within ``chip_smoke.BF16_GATE`` (2^-6 |ref| + 2^-5 rms: both
sides round p, dS and the output to bf16 at other running maxima and in
another order). The tiny model: fp32 logits at 1e-4 (the decoder tests'), fp32
gradients at ``GRAD_TOL`` (that of ``test_torch_fp32_kernels.py``); in bf16,
where each package rounds every activation of two tower, two guide and two
decoder layers to bf16 in its own order, the logits within 2^-4 of the
largest |logit|, the loss within 2% and each gradient tensor within 5% of
its norm (the rules of ``chip_smoke.py``'s 2-layer kernel-against-plain
comparison; a gradient the softmax cancels, exactly 0, below 2^-16 of the
largest gradient element on both sides), the greedy ids equal.
One torch thread (the test workers share the machine's cores).
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
from hicom_tpu.ops import flash_attention as jfa
from hicom_tpu.train import train_step as jstep
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models import qwen2 as tqwen2
from hicom_tpu_torch.models.generate import generate_tokens as t_generate
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.ops import attention as tattn
from hicom_tpu_torch.ops import flash_attention as tfa
from hicom_tpu_torch.ops import flash_decode as tfd
from hicom_tpu_torch.ops import local_attn as tla
from hicom_tpu_torch.ops.cuda_build import plain_route
from hicom_tpu_torch.train import optimizer as topt
from hicom_tpu_torch.train import train_step as tstep
from hicom_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_fp32_kernels import _card_routes_on_the_cpu

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
MERGE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL32 = dict(rtol=5e-5, atol=5e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 1e-4  # test_torch_fp32_kernels.py: 1e-4 of the value plus 1e-4 of the tensor's largest |value|
VIDEO, IGNORE = -201, -100
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def _valid(x, lens, L):
    if not lens:
        return np.asarray(x)
    return np.where((np.arange(L)[None, :] < np.asarray(lens)[:, None])[:, None, :, None], np.asarray(x), 0)


def _close(got, ref, dtype, what, tol=FWD_TOL):
    """fp32: ``tol``; bf16: every element within ``chip_smoke.BF16_GATE``."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, err_msg=what, **tol)
        return
    err, ratio, rms, _ = chip_smoke.agreement(torch.from_numpy(got), torch.from_numpy(ref))
    assert ratio <= 1 and rms > 0, f"{what}: max err {err}, worst err/tol {ratio}"


def _pair(dtype, *xs):
    """numpy inputs as (JAX arrays, torch tensors) of ``dtype``."""
    jt, tt = DTYPES[dtype]
    return [jnp.asarray(x, jt) for x in xs], [torch.from_numpy(x).to(tt) for x in xs]


# --------------------------------------------------------------------------- #
# the forward: K1 and K2's twins against the Pallas kernels
# --------------------------------------------------------------------------- #

def test_wide_head_dims_take_the_padded_instances():
    assert [tfa._padded(d) for d in (128, 136, 192, 200, 248, 256)] == [128, 192, 192, 256, 256, 256]
    for d in (136, 192, 200, 256):
        assert tfa.takes_flash_kernel(d, (torch.bfloat16,) * 3, "cuda")
        assert tfa.takes_flash_backward(d, (torch.float32,) * 3, "cuda")
    assert not tfa.takes_flash_kernel(264, (torch.bfloat16,) * 3, "cuda")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [136, 192, 256])
def test_k1_twin_matches_pallas_at_wide_heads(d, dtype):
    rng = np.random.default_rng(d)
    (jq, jk, jv), (tq, tk, tv) = _pair(dtype, *(_rand(rng, 2, 150, d) for _ in range(3)))
    ref, ref_lse = jfa._fullblock_fwd(jq, jk, jv, d**-0.5, 0.25, True)
    got, got_lse = tfa.fullblock_attention(tq, tk, tv, d**-0.5, 0.25)
    assert got.dtype == DTYPES[dtype][1]
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), dtype, f"K1 d {d}")
    np.testing.assert_allclose(got_lse.float().numpy(), np.asarray(ref_lse, np.float32), rtol=1e-4, atol=1e-4)


K2_CASES = {
    # name: (b, H, KVH, L, d, causal, lens, blocks): blocks 64 is JAX's blocked kernel, 1024 one whole block
    "d256_gqa7_causal_lengths": (2, 7, 1, 130, 256, True, [130, 90], 64),
    "d192_gqa3_causal": (2, 3, 1, 140, 192, True, None, 64),
    "d192_one_block_lengths": (2, 2, 2, 150, 192, False, [150, 101], 1024),
    "d136_one_block": (2, 2, 2, 150, 136, False, None, 1024),  # full block, no mask: the K1 route
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_k2_twin_matches_pallas_at_wide_heads(name, dtype):
    b, H, KVH, L, d, causal, lens, blocks = K2_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    (jq, jk, jv), (tq, tk, tv) = _pair(dtype, _rand(rng, b, H, L, d), _rand(rng, b, KVH, L, d),
                                       _rand(rng, b, KVH, L, d))
    kw = dict(is_causal=causal, block_q=blocks, block_k=blocks)
    jentry, tentry = (jfa.flash_attention_gqa, tfa.flash_attention_gqa) if H != KVH else \
        (jfa.flash_attention, tfa.flash_attention)
    ref = jentry(jq, jk, jv, kv_lengths=jnp.asarray(lens, jnp.int32) if lens else None, interpret=True, **kw)
    got = tentry(tq, tk, tv, kv_lengths=torch.tensor(lens, dtype=torch.int32) if lens else None, **kw)
    _close(_valid(got.float().numpy(), lens, L), _valid(np.asarray(ref.astype(jnp.float32)), lens, L), dtype, name)
    # the route the card takes for these shapes: K2, or K1 for the unmasked whole block
    route = tattn.flash_route((b, H, L, d), (b, KVH, L, d), is_causal=causal, kv_lengths=lens)
    assert route == ("fullblock" if name == "d136_one_block" else "flash")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_forward_and_merge_at_d256(dtype):
    """The global compressor's form at d 256: 32 queries over 700 keys, the
    kernel's chunks (3 of 64-key tiles) merged, and the split-key route
    (partials, then ``merge_partials``), against the Pallas kernel."""
    rng = np.random.default_rng(700)
    (jq, jk, jv), (tq, tk, tv) = _pair(dtype, _rand(rng, 1, 4, 32, 256), _rand(rng, 1, 4, 700, 256),
                                       _rand(rng, 1, 4, 700, 256))
    ref = np.asarray(jfa.flash_attention(jq, jk, jv, interpret=True).astype(jnp.float32))
    out, _ = tfa.split_forward_reference(tq, tk, tv, None, 256**-0.5, 0.0, False, 3)
    _close(out.float().numpy(), ref, dtype, "split forward", MERGE_TOL)
    routed = tattn.sdpa(tq, tk, tv, kv_group=tattn.SoloGroup())
    assert routed.dtype == DTYPES[dtype][1]
    _close(routed.float().numpy(), ref, dtype, "partials + merge", MERGE_TOL)


# --------------------------------------------------------------------------- #
# the backward: K5/K6's twins against jax.vjp of the Pallas backward
# --------------------------------------------------------------------------- #

BWD_CASES = {
    # name: (b, H, KVH, Lq, Lk, d, causal, lens, bias, gqa_entry)
    "d256_gqa7_causal_lengths": (2, 7, 1, 100, 100, 256, True, [100, 70], 0.0, True),
    "d256_causal_lq_ne_lk": (1, 2, 2, 64, 160, 256, True, None, 0.0, False),
    "d192_kv_lengths_bias": (2, 2, 2, 96, 96, 192, False, [60, 96], 0.3, False),
    "d192_gqa3_causal": (2, 6, 2, 64, 64, 192, True, None, -0.3, True),
}


def _grads(fn, leaves, do):
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, do)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_backward_twin_matches_pallas_backward_at_wide_heads(name, dtype):
    b, H, KVH, Lq, Lk, d, causal, lens, bias, gqa = BWD_CASES[name]
    tt = DTYPES[dtype][1]
    rng = np.random.default_rng(sum(map(ord, name)))
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _pair(dtype, _rand(rng, b, H, Lq, d), _rand(rng, b, KVH, Lk, d),
                                                 _rand(rng, b, KVH, Lk, d), _rand(rng, b, H, Lq, d))
    jl = jnp.asarray(lens, jnp.int32) if lens else None
    tl = torch.tensor(lens, dtype=torch.int32) if lens else None
    jentry, tentry = (jfa.flash_attention_gqa, tfa.flash_attention_gqa) if gqa else \
        (jfa.flash_attention, tfa.flash_attention)
    kw = dict(is_causal=causal, logit_bias=bias, block_q=64, block_k=64)
    _, vjp = jax.vjp(lambda q, k, v: jentry(q, k, v, kv_lengths=jl, interpret=True, **kw), jq, jk, jv)
    ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    out, lse = tfa.flash_forward(tq, tk, tv, tl, d**-0.5, bias, causal)
    twin = tfa.flash_backward_reference(tq, tk, tv, tl, out, lse, tdo, d**-0.5, bias, causal)
    assert all(t.dtype == tt for t in twin)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    _, port = _grads(lambda q, k, v: tentry(q, k, v, kv_lengths=tl, **kw), leaves, tdo)
    for n, r, t, p in zip("qkv", ref, twin, port):
        _close(t.float().numpy(), r, dtype, f"d{n} (twin)", GRAD_TOL32)
        _close(p.float().numpy(), r, dtype, f"d{n} (Function)", GRAD_TOL32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [136, 256])
def test_fullblock_route_backward_at_wide_heads(d, dtype):
    rng = np.random.default_rng(d + 1)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _pair(dtype, *(_rand(rng, 2, 137, d) for _ in range(4)))
    blocks = dict(block_q=1024, block_k=1024, logit_bias=0.25)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, interpret=True, **blocks), jq, jk, jv)
    ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    _, port = _grads(lambda q, k, v: tfa.flash_attention(q, k, v, **blocks), leaves, tdo)
    for n, r, p in zip("qkv", ref, port):
        _close(p.float().numpy(), r, dtype, f"d{n}", GRAD_TOL32)


@pytest.mark.parametrize("n_split", [1, 3, 7])
@pytest.mark.parametrize("shape", [(2, 3, 3, 32, 700, False, None), (2, 7, 1, 150, 150, True, [150, 97])])
def test_split_twins_match_the_unsplit_twin_at_d256(shape, n_split):
    """K5's key chunks and K6's unit ranges at d 256, summed in fp32, give the
    unsplit twin's gradients (fp32, ``GRAD_TOL32``): the global compressor's
    32-row query blocks, and the d-256 decoder's grouped causal rows with
    chunks and ranges wholly masked."""
    b, H, KVH, Lq, Lk, causal, lens = shape
    d = 256
    rng = np.random.default_rng(n_split + Lk)
    q, k, v, do = (torch.from_numpy(_rand(rng, *s)) for s in ((b, H, Lq, d), (b, KVH, Lk, d), (b, KVH, Lk, d),
                                                               (b, H, Lq, d)))
    kl = torch.tensor(lens, dtype=torch.int32) if lens else None
    out, lse = tfa.flash_forward(q, k, v, kl, d**-0.5, 0.1, causal)
    whole = tfa.flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, 0.1, causal)
    split = (tfa.split_dq_reference(q, k, v, kl, out, lse, do, d**-0.5, 0.1, causal, n_split),) + \
        tfa.split_dkv_reference(q, k, v, kl, out, lse, do, d**-0.5, 0.1, causal, n_split)
    for n, got, want in zip(("dq", "dk", "dv"), split, whole):
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=n, **GRAD_TOL32)


# --------------------------------------------------------------------------- #
# the slice: a tiny HICom whose decoder has heads of 256
# --------------------------------------------------------------------------- #

def _configs(dtype):
    """``tiny_test_config`` with the decoder at 2 query heads and 1 kv head of 256 (q 512 wide)."""
    out = []
    for mod in (jcfg, tcfg):
        c = mod.tiny_test_config(use_guide="direct", dtype=dtype)
        out.append(c.replace(text_config=dataclasses.replace(c.text_config, num_attention_heads=2,
                                                             num_key_value_heads=1, head_dim=256)))
    return out


def _request(seed, L=130):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, (1, L))
    ids[0, 2] = VIDEO
    frames = rng.standard_normal((1, 4, 3, 56, 56)).astype(np.float32)
    return ids, np.asarray(jnp.asarray(frames, jnp.bfloat16).astype(jnp.float32)), rng.integers(1, 250, (1, 16))


_MODELS = {}


def _models(dtype):
    """JAX's model and parameters (bf16-exact values for bf16) and the port's model carrying them."""
    if dtype not in _MODELS:
        cj, ct = _configs(dtype)
        ids, frames, gids = _request(0)
        jm = JModel(config=cj)
        params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(frames),
                                                 guide_ids=jnp.asarray(gids))["params"])
        if dtype == "bfloat16":
            params = jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                                            if x.dtype == np.float32 else x, params)
        tm = TModel(ct)
        tm.load_state_dict(state_dict_from_jax(params, ct), strict=True)
        assert tm.model.layers[0].self_attn.q_proj.weight.dtype == DTYPES[dtype][1]
        _MODELS[dtype] = (jm, params, tm.eval())
    return _MODELS[dtype]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_d256_slice_generates_jax_ids(dtype, monkeypatch):
    """One video request: the last prompt token's logits and 8 greedy ids
    against JAX's, the decoder's prefill through the K2 twin at d 256."""
    jm, params, tm = _models(dtype)
    calls = _card_routes_on_the_cpu(monkeypatch)
    ids, frames, gids = _request(1)
    jt = DTYPES[dtype][0]
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jt) if x.dtype == np.float32 else x, params)
    ref, _, _ = jax.jit(lambda p, i, f, g: jm.apply({"params": p}, i, f, guide_ids=g))(
        jparams if dtype == "bfloat16" else params, jnp.asarray(ids), jnp.asarray(frames), jnp.asarray(gids))
    with torch.no_grad():
        got, _, _ = tm.one_shot_forward(torch.from_numpy(ids), torch.from_numpy(frames),
                                        guide_ids=torch.from_numpy(gids))
    ref, got = np.asarray(ref.astype(jnp.float32))[:, -1], got.float().numpy()[:, -1]
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **LOGIT_TOL)
    else:
        assert np.abs(got - ref).max() <= 2**-4 * np.abs(ref).max()
    assert ("flash", 256, False) in calls
    kw = dict(modal="video", max_new_tokens=8, eos_token_id=-1, cache_len=256)
    want = j_generate({"params": params}, jnp.asarray(ids), jnp.asarray(frames), jnp.asarray(gids), None,
                      jax.random.PRNGKey(0), None, model=jm, **kw)
    got_ids = t_generate(tm, torch.from_numpy(ids), torch.from_numpy(frames), torch.from_numpy(gids), None, None,
                         **kw)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want))


def _train_batch(seed=3, L=130):
    """b = 2 rows of ``L`` ids with a <video> sentinel, the second right-padded
    from 110; the first 8 labels and the padding ignored; 4 frames; guide ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, (2, L))
    ids[:, 2] = VIDEO
    mask = np.ones((2, L), bool)
    mask[1, 110:] = False
    ids[1, 110:] = 0
    labels = np.where(mask, ids, IGNORE)
    labels[:, :8] = IGNORE
    frames = rng.standard_normal((2, 4, 3, 56, 56)).astype(np.float32)
    return dict(input_ids=ids, attention_mask=mask, labels=labels,
                frames=np.asarray(jnp.asarray(frames, jnp.bfloat16).astype(jnp.float32)),
                guide_ids=rng.integers(1, 250, (2, 16)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_d256_stage2_step_matches_jax(dtype, monkeypatch):
    """One stage-2 step (``mm_projector``, the direct guide) with the card's
    routes: the decoder's d-256 prefill trains through ``FlashAttention`` and
    the K5/K6 twin; the loss and every trained gradient against
    ``jax.value_and_grad`` of JAX's loss on the same weights."""
    jm, params, tm = _models(dtype)
    loss_fn = jstep.make_loss_fn(jm, tunable_parts="mm_projector", use_guide="direct")
    batch = _train_batch()
    (want_loss, _), want = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = state_dict_from_jax(jax.device_get(want), _configs(dtype)[1])
    calls = _card_routes_on_the_cpu(monkeypatch)
    trained = [n for n, p in tm.named_parameters() if topt.is_tunable(n, "mm_projector", "direct")]
    tm.train()
    try:
        for n, p in tm.named_parameters():
            p.requires_grad_(n in trained)
            p.grad = None
        loss, _ = tstep.make_loss_fn(tm)(tstep.batch_to_device(batch, torch.device("cpu"), DTYPES[dtype][1]))
        loss.backward()
        got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).float() for n, p in tm.named_parameters()
               if n in trained}
    finally:
        for p in tm.parameters():
            p.requires_grad_(False)
            p.grad = None
        tm.eval()
    assert ("flash", 256, True) in calls
    assert len(got) == len(trained) > 0
    if dtype == "float32":
        np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
        top = max(float(want[n].abs().max()) for n in got)
        for n, g in got.items():
            ref = want[n].float().numpy()
            atol = GRAD_TOL * max(float(np.abs(ref).max()), 1e-6 * top)
            np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_TOL, atol=atol, err_msg=n)
        return
    assert abs(float(loss.detach()) - float(want_loss)) <= 0.02 * abs(float(want_loss))
    # a tensor whose exact gradient is 0 (the keys' bias, which the softmax cancels) carries rounding noise on
    # both sides: it is held below 2^-16 of the largest gradient element on both (as chip_smoke.py's
    # [fp32-train] holds it, with bf16's noise in place of fp32's)
    noise = 2**-16 * max(float(want[n].abs().max()) for n in got)
    for n, g in got.items():
        ref = want[n].float()
        if float(ref.abs().max()) <= noise:
            assert float(g.abs().max()) <= noise, n
        else:
            assert float((g - ref).norm()) <= 0.05 * float(ref.norm()), n


@pytest.mark.parametrize("dtype,symbol", [(torch.float32, "_f32"), (torch.bfloat16, "")])
def test_d256_slice_routes_on_the_device_branch(monkeypatch, dtype, symbol):
    """The tiny d-256 model on meta tensors, launches stubbed: each decoder
    layer's prefill launches K2, a one-token step takes the plain masked
    attention by K3's contract (counted once per layer), and the backward of
    the decoder launches K5/K6 once per layer, in the instance of its dtype."""
    symbols = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for mod in (tfa, tfd, tla):
        monkeypatch.setattr(mod, "c_function", lambda name, sym, *a, **k: symbols.append(sym) or (lambda *args: 0))
    for mod in (tfa, tla):
        monkeypatch.setattr(mod, "_sm_count", lambda index: 132)
    _, ct = _configs("float32" if dtype == torch.float32 else "bfloat16")
    cfg = ct.text_config
    with torch.device("meta"):
        model = tqwen2.Qwen2Model(cfg, dtype=dtype)
    before = tfa.flash_forward.launches, tfa.flash_backward.launches, tfd.flash_decode.launches
    plain_route.reset()
    b, L, hid = 2, 140, cfg.hidden_size
    cache = tqwen2.KVCache.zeros(cfg.num_hidden_layers, b, 1, 256, 256, dtype, "meta")
    pos = torch.arange(L, device="meta").expand(b, L)
    with torch.inference_mode():
        model(torch.empty((b, L, hid), dtype=dtype, device="meta"), pos, cache, prefill_from_empty=True)
        model(torch.empty((b, 1, hid), dtype=dtype, device="meta"), pos[:, -1:] + 1, cache)
    layers = cfg.num_hidden_layers
    assert tfa.flash_forward.launches - before[0] == layers and tfd.flash_decode.launches == before[2]
    assert plain_route.counts["K3"] == layers
    x = torch.empty((b, L, hid), dtype=dtype, device="meta", requires_grad=True)
    hidden = model(x, pos, padding_mask=torch.ones((b, L), dtype=torch.bool, device="meta"))
    hidden.backward(torch.empty_like(hidden))
    assert tfa.flash_backward.launches - before[1] == layers
    assert [s for s in symbols if "bwd" in s] == [f"hicom_flash_bwd_{k}{symbol}" for _ in range(layers)
                                                 for k in ("dq", "dkv")]
    plain_route.reset()
