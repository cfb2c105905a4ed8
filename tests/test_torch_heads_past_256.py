"""Attention past head dim 256 (``flash_wide.cu``, ``flash_wide_f32.cu``) against the JAX package on the CPU.

JAX's Pallas kernels have no width limit: its ``auto`` rule sends them every
head dim that is a multiple of 64 at any length (320, 384, 512, ...), and
every multiple of 8 in one unmasked or length-masked block of at most 1,024
rows (264, 288, ...). The port's kernels take every such head dim on the card:
past 256 the head dim is a runtime argument of the wide kernels, which cut
the output's columns into blocks. Here the twins that those kernels are held
to on the card run against the Pallas kernels in interpret mode, on inputs
from a numpy seed, in fp32 and bf16:

* the contract: ``takes_flash_kernel`` and ``takes_flash_backward`` at d 264
  to 2,048 in bf16 and fp32 on a device, not for fp16 nor d % 8 != 0, and the
  wide sources and symbols the launchers pick;
* the forward: K1 (``_fullblock_fwd``) at d 264, 288 and 512; K2 at d 512
  grouped 7:1, causal with ``kv_lengths`` (the d-512 decoder's heads), at d
  320 grouped 4:1 causal, at d 384 in one block with lengths, and d 264 in one
  unmasked block through ``flash_attention``'s full-block route; the split
  forward and the split-key route's partials + merge at d 512;
* the backward: the K5/K6 twin and the ``FlashAttention`` Function against
  ``jax.vjp`` of the Pallas backward at d 320 and 512, and the full-block
  route at d 288; the split twins against the unsplit twin at d 512;
* a tiny HICom whose decoder has 2 query heads and 1 kv head of 512 and
  whose tower has one head of 288, carried from JAX by ``state_dict_from_jax``
  (bf16 on the same bf16-rounded weights): greedy ids and last-token logits
  of one video request, and one stage-2 step's loss and projector gradients,
  with the card's routes taken on the CPU (the tower on the K1 twin at d 288,
  the prefill on the K2 twin at d 512, the step on the K5/K6 twin); then the
  same model on meta tensors through the wrappers' device branch: K1 at d
  288, K2 at d 512, the one-token step on the plain route by K3's contract,
  and the wide K5/K6 symbols of its dtype.

Tolerances, those of ``test_torch_wide_heads.py``: fp32 forward 2e-5 and the
merged rows 1e-5 (rtol and atol: the same fp32 arithmetic in another
summation order), fp32 gradients 5e-5. bf16 kernels: every element within
``chip_smoke.BF16_GATE`` (2^-6 |ref| + 2^-5 rms: both sides round p, dS and
the output to bf16 at other running maxima and in another order). The tiny
model: fp32 logits at 1e-4, fp32 gradients at ``GRAD_TOL`` (a gradient the
softmax cancels, the global compressor's keys' bias, whose exact value is 0,
held below 2^-20 of the largest gradient element on both sides, as
``chip_smoke.py``'s [fp32-train] holds it); in bf16 the
logits within 2^-4 of the largest |logit|, the loss within 2% and each
gradient tensor within 5% of its norm (a gradient the softmax cancels,
exactly 0, below 2^-16 of the largest gradient element on both sides), the
greedy ids equal. One torch thread (the test workers share the machine's
cores).
"""

import collections
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models.generate import generate_tokens as j_generate
from hicom_tpu.models.hicom import HIComModel as JModel
from hicom_tpu.ops import flash_attention as jfa
from hicom_tpu.train import train_step as jstep
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models import qwen2 as tqwen2
from hicom_tpu_torch.models import siglip as tsiglip
from hicom_tpu_torch.models.generate import generate_tokens as t_generate
from hicom_tpu_torch.models.hicom import HIComModel as TModel
from hicom_tpu_torch.ops import attention as tattn
from hicom_tpu_torch.ops import flash_attention as tfa
from hicom_tpu_torch.ops import flash_decode as tfd
from hicom_tpu_torch.ops import local_attn as tla
from hicom_tpu_torch.ops.cuda_build import SOURCES, plain_route
from hicom_tpu_torch.train import optimizer as topt
from hicom_tpu_torch.train import train_step as tstep
from hicom_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_fp32_kernels import _card_routes_on_the_cpu
from tests.test_torch_wide_heads import (DTYPES, GRAD_TOL, GRAD_TOL32, IGNORE, LOGIT_TOL, MERGE_TOL, VIDEO, _close,
                                         _grads, _pair, _rand, _valid)

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


# --------------------------------------------------------------------------- #
# the contract
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("d", [264, 288, 320, 384, 512, 1024, 2048])
def test_every_head_dim_past_256_takes_the_wide_kernels(d, dtype):
    assert tfa.takes_flash_kernel(d, (dtype,) * 3, "cuda")
    assert tfa.takes_flash_backward(d, (dtype,) * 3, "cuda")
    f32 = "_f32" if dtype == F32 else ""
    assert tfa._source("fwd", dtype, d) == (f"flash_wide{f32}", f"hicom_flash_fwd_wide{f32}")
    assert tfa._source("bwd_dq", dtype, d) == (f"flash_wide{f32}", f"hicom_flash_bwd_dq_wide{f32}")
    assert tfa._source("bwd_dkv", dtype, d) == (f"flash_wide{f32}", f"hicom_flash_bwd_dkv_wide{f32}")
    assert f"flash_wide{f32}" in SOURCES


@pytest.mark.parametrize("d,dtypes", [(512, (torch.float16,) * 3), (320, (BF16, BF16, F32)), (260, (BF16,) * 3),
                                      (516, (F32,) * 3)])
def test_past_256_still_refuses_fp16_mixed_types_and_odd_widths(d, dtypes):
    assert not tfa.takes_flash_kernel(d, dtypes, "cuda")
    assert not tfa.takes_flash_backward(d, dtypes, "cuda")
    assert tfa.takes_flash_kernel(d, dtypes, "cpu")  # the plain twins take anything


def test_up_to_256_keeps_its_instances():
    assert [tfa._source("fwd", BF16, d) for d in (72, 256)] == [("flash_fwd", "hicom_flash_fwd")] * 2
    assert tfa._source("bwd_dkv", F32, 192) == ("flash_bwd_f32", "hicom_flash_bwd_dkv_f32")
    assert [tfa.wide_column_blocks(d, "fwd") for d in (256, 264, 512, 1024)] == [1, 2, 2, 4]
    assert [tfa.wide_column_blocks(d, "dkv") for d in (256, 264, 512, 1024)] == [1, 3, 4, 8]
    # the wide grids fill the card at the [hd512] prefill's shapes: no split of the forward or K5 there
    assert tfa.forward_splits(2, 7, 743, 743, d=512) == 1 and tfa.dq_splits(2, 7, 743, 743, d=512) == 1


# --------------------------------------------------------------------------- #
# the forward: K1 and K2's twins against the Pallas kernels
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [264, 288, 512])
def test_k1_twin_matches_pallas_past_256(d, dtype):
    rng = np.random.default_rng(d)
    (jq, jk, jv), (tq, tk, tv) = _pair(dtype, *(_rand(rng, 2, 150, d) for _ in range(3)))
    ref, ref_lse = jfa._fullblock_fwd(jq, jk, jv, d**-0.5, 0.25, True)
    got, got_lse = tfa.fullblock_attention(tq, tk, tv, d**-0.5, 0.25)
    assert got.dtype == DTYPES[dtype][1]
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), dtype, f"K1 d {d}")
    np.testing.assert_allclose(got_lse.float().numpy(), np.asarray(ref_lse, np.float32), rtol=1e-4, atol=1e-4)


K2_CASES = {
    # name: (b, H, KVH, L, d, causal, lens, blocks): blocks 64 is JAX's blocked kernel, 1024 one whole block
    "d512_gqa7_causal_lengths": (2, 7, 1, 130, 512, True, [130, 90], 64),
    "d320_gqa4_causal": (1, 4, 1, 140, 320, True, None, 64),
    "d384_one_block_lengths": (2, 2, 2, 150, 384, False, [150, 101], 1024),
    "d264_one_block": (2, 2, 2, 150, 264, False, None, 1024),  # full block, no mask: the K1 route
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_k2_twin_matches_pallas_past_256(name, dtype):
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
    assert route == ("fullblock" if name == "d264_one_block" else "flash")


def test_jax_rule_routes_the_hd512_shapes():
    """``flash_route`` follows JAX's rule at ``[hd512]``'s shapes: the
    tower's 729 tokens at d 288 in one block go to K1, the decoder's grouped
    d-512 prefill to K2, and d 288 past one block (or grouped) to the plain
    path, as JAX's ``d % 64`` rule sends it to XLA."""
    assert tattn.flash_route((64, 4, 729, 288), (64, 4, 729, 288)) == "fullblock"
    assert tattn.flash_route((2, 7, 743, 512), (2, 1, 743, 512), is_causal=True, kv_lengths=[743, 700]) == "flash"
    assert tattn.flash_route((1, 4, 2000, 288), (1, 4, 2000, 288)) is None
    assert tattn.flash_route((1, 8, 300, 288), (1, 2, 300, 288), is_causal=True) is None


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_forward_and_merge_at_d512(dtype):
    """The split forward at d 512: 32 queries over 700 keys, the kernel's
    chunks (3 of 64-key tiles) merged, and the split-key route (partials,
    then ``merge_partials``), against the Pallas kernel."""
    rng = np.random.default_rng(512)
    (jq, jk, jv), (tq, tk, tv) = _pair(dtype, _rand(rng, 1, 2, 32, 512), _rand(rng, 1, 2, 700, 512),
                                       _rand(rng, 1, 2, 700, 512))
    ref = np.asarray(jfa.flash_attention(jq, jk, jv, interpret=True).astype(jnp.float32))
    out, _ = tfa.split_forward_reference(tq, tk, tv, None, 512**-0.5, 0.0, False, 3)
    _close(out.float().numpy(), ref, dtype, "split forward", MERGE_TOL)
    routed = tattn.sdpa(tq, tk, tv, kv_group=tattn.SoloGroup())
    assert routed.dtype == DTYPES[dtype][1]
    _close(routed.float().numpy(), ref, dtype, "partials + merge", MERGE_TOL)


# --------------------------------------------------------------------------- #
# the backward: K5/K6's twins against jax.vjp of the Pallas backward
# --------------------------------------------------------------------------- #

BWD_CASES = {
    # name: (b, H, KVH, Lq, Lk, d, causal, lens, bias, gqa_entry)
    "d512_gqa7_causal_lengths": (2, 7, 1, 100, 100, 512, True, [100, 70], 0.0, True),
    "d320_gqa2_causal_bias": (1, 4, 2, 64, 96, 320, True, None, -0.3, True),
    "d512_kv_lengths_bias": (2, 2, 2, 96, 96, 512, False, [60, 96], 0.3, False),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_backward_twin_matches_pallas_backward_past_256(name, dtype):
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
def test_fullblock_route_backward_at_d288(dtype):
    rng = np.random.default_rng(289)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _pair(dtype, *(_rand(rng, 2, 137, 288) for _ in range(4)))
    blocks = dict(block_q=1024, block_k=1024, logit_bias=0.25)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, interpret=True, **blocks), jq, jk, jv)
    ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    _, port = _grads(lambda q, k, v: tfa.flash_attention(q, k, v, **blocks), leaves, tdo)
    for n, r, p in zip("qkv", ref, port):
        _close(p.float().numpy(), r, dtype, f"d{n}", GRAD_TOL32)


@pytest.mark.parametrize("n_split", [1, 3, 7])
@pytest.mark.parametrize("shape", [(1, 2, 2, 32, 700, False, None), (2, 7, 1, 150, 150, True, [150, 97])])
def test_split_twins_match_the_unsplit_twin_at_d512(shape, n_split):
    """K5's key chunks and K6's unit ranges at d 512, summed in fp32, give the
    unsplit twin's gradients (fp32, ``GRAD_TOL32``): 32-row query blocks over
    many keys, and the d-512 decoder's grouped causal rows with chunks and
    ranges wholly masked."""
    b, H, KVH, Lq, Lk, causal, lens = shape
    d = 512
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
# the slice: a tiny HICom whose decoder has heads of 512 and whose tower has a head of 288
# --------------------------------------------------------------------------- #

def _configs(dtype):
    """``tiny_test_config`` with the decoder at 2 query heads and 1 kv head of
    512 (q 1,024 wide) and the tower at one head of 288 (hidden 288, the
    guide's projection with it) over 168 x 168 frames, whose 144 tokens take
    K1 by JAX's one-block rule."""
    out = []
    for mod in (jcfg, tcfg):
        c = mod.tiny_test_config(use_guide="direct", dtype=dtype)
        out.append(c.replace(
            text_config=dataclasses.replace(c.text_config, num_attention_heads=2, num_key_value_heads=1,
                                            head_dim=512),
            vision_config=dataclasses.replace(c.vision_config, hidden_size=288, num_attention_heads=1,
                                              image_size=168),
            guide_text_config=dataclasses.replace(c.guide_text_config, projection_size=288)))
    return out


def _frames(rng, b):
    frames = rng.standard_normal((b, 4, 3, 168, 168)).astype(np.float32)
    return np.asarray(jnp.asarray(frames, jnp.bfloat16).astype(jnp.float32))


def _request(seed, L=130):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, (1, L))
    ids[0, 2] = VIDEO
    return ids, _frames(rng, 1), rng.integers(1, 250, (1, 16))


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
        assert tm.model.layers[0].self_attn.q_proj.weight.shape == (1024, 128)
        assert tm.model.layers[0].self_attn.k_proj.weight.dtype == DTYPES[dtype][1]
        _MODELS[dtype] = (jm, params, tm.eval())
    return _MODELS[dtype]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_d512_slice_generates_jax_ids(dtype, monkeypatch):
    """One video request: the last prompt token's logits and 8 greedy ids
    against JAX's, the tower through the K1 twin at d 288 and the decoder's
    prefill through the K2 twin at d 512."""
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
    assert ("flash", 512, False) in calls and ("fullblock", 288, False) in calls
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
    return dict(input_ids=ids, attention_mask=mask, labels=labels, frames=_frames(rng, 2),
                guide_ids=rng.integers(1, 250, (2, 16)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_d512_stage2_step_matches_jax(dtype, monkeypatch):
    """One stage-2 step (``mm_projector``, the direct guide) with the card's
    routes: the decoder's d-512 prefill trains through ``FlashAttention`` and
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
    assert ("flash", 512, True) in calls
    assert len(got) == len(trained) > 0
    if dtype == "float32":
        np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
        top = max(float(want[n].abs().max()) for n in got)
        for n, g in got.items():
            ref = want[n].float().numpy()
            if np.abs(ref).max() <= 2**-20 * top:  # cancelled by the softmax: fp32 noise on both sides
                assert float(g.abs().max()) <= 2**-20 * top, n
                continue
            atol = GRAD_TOL * max(float(np.abs(ref).max()), 1e-6 * top)
            np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_TOL, atol=atol, err_msg=n)
        return
    assert abs(float(loss.detach()) - float(want_loss)) <= 0.02 * abs(float(want_loss))
    noise = 2**-16 * max(float(want[n].abs().max()) for n in got)
    for n, g in got.items():
        ref = want[n].float()
        if float(ref.abs().max()) <= noise:
            assert float(g.abs().max()) <= noise, n
        else:
            assert float((g - ref).norm()) <= 0.05 * float(ref.norm()), n


@pytest.mark.parametrize("dtype,symbol", [(F32, "_wide_f32"), (BF16, "_wide")])
def test_d512_slice_routes_on_the_device_branch(monkeypatch, dtype, symbol):
    """The tiny model's tower and decoder on meta tensors, launches stubbed:
    the tower's attention launches K1 at d 288 once per layer, each decoder
    layer's prefill launches K2 at d 512 (the wide forward), a one-token step
    takes the plain masked attention by K3's contract (counted once per
    layer), and the backward of the decoder launches the wide K5/K6 of its
    dtype once per layer; ``source_launches`` counts each of them, and the
    split paths' merge and sum passes, under the wide library."""
    symbols = []
    launched = collections.Counter()
    monkeypatch.setattr(tfa, "source_launches", launched)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for mod in (tfa, tfd, tla):
        monkeypatch.setattr(mod, "c_function", lambda name, sym, *a, **k: symbols.append(sym) or (lambda *args: 0))
    for mod in (tfa, tla):
        monkeypatch.setattr(mod, "_sm_count", lambda index: 132)
    _, ct = _configs("float32" if dtype == F32 else "bfloat16")
    cfg, vc = ct.text_config, ct.vision_config
    before = tfa.fullblock_attention.launches, tfa.flash_forward.launches, tfa.flash_backward.launches, \
        tfd.flash_decode.launches
    with torch.device("meta"):
        tower = tsiglip.SiglipEncoder(vc.num_hidden_layers, vc.hidden_size, vc.intermediate_size,
                                      vc.num_attention_heads, vc.layer_norm_eps, dtype=dtype)
        model = tqwen2.Qwen2Model(cfg, dtype=dtype)
    with torch.inference_mode():
        tower(torch.empty((8, vc.num_patches, vc.hidden_size), dtype=dtype, device="meta"))
    assert tfa.fullblock_attention.launches - before[0] == vc.num_hidden_layers
    assert symbols == ["hicom_flash_fwd_wide" + symbol[len("_wide"):]] * vc.num_hidden_layers
    plain_route.reset()
    b, L, hid = 2, 140, cfg.hidden_size
    cache = tqwen2.KVCache.zeros(cfg.num_hidden_layers, b, 1, 256, 512, dtype, "meta")
    pos = torch.arange(L, device="meta").expand(b, L)
    with torch.inference_mode():
        model(torch.empty((b, L, hid), dtype=dtype, device="meta"), pos, cache, prefill_from_empty=True)
        model(torch.empty((b, 1, hid), dtype=dtype, device="meta"), pos[:, -1:] + 1, cache)
    layers = cfg.num_hidden_layers
    assert tfa.flash_forward.launches - before[1] == layers and tfd.flash_decode.launches == before[3]
    assert plain_route.counts["K3"] == layers
    x = torch.empty((b, L, hid), dtype=dtype, device="meta", requires_grad=True)
    hidden = model(x, pos, padding_mask=torch.ones((b, L), dtype=torch.bool, device="meta"))
    hidden.backward(torch.empty_like(hidden))
    assert tfa.flash_backward.launches - before[2] == layers
    assert [s for s in symbols if "bwd" in s] == [f"hicom_flash_bwd_{k}{symbol}" for _ in range(layers)
                                                 for k in ("dq", "dkv")]
    # at these small shapes the wide grids do not fill 132 SMs: every K1, K2, K5 and K6 launch is split
    lib = "flash" + symbol
    tower_layers = vc.num_hidden_layers
    assert launched == {("K1", lib): tower_layers, ("K1-merge", lib): tower_layers, ("K2", lib): 2 * layers,
                        ("K2-merge", lib): 2 * layers, ("K5", lib): layers, ("K5-sum", lib): layers,
                        ("K6", lib): layers, ("K6-sum", lib): layers}
    plain_route.reset()
