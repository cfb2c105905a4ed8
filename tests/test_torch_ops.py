"""Port ops vs the JAX package: each kernel's plain twin against the Pallas kernel
run in interpret mode, the sdpa dispatcher against JAX's ``auto`` rule, and the
small ops (resize, tiling, position embedding).

Inputs come from numpy seeds and go to both packages. Unless a test says
otherwise the comparison is fp32 on the CPU with atol = rtol = 2e-5: both sides
compute the same fp32 arithmetic in another summation order (the bound the JAX
package's own flash tests use).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu.ops import attention as jattn
from hicom_tpu.ops import flash_attention as jfa
from hicom_tpu.ops.flash_decode import flash_decode as j_flash_decode
from hicom_tpu.ops.grouping import tile_thw as j_tile_thw
from hicom_tpu.ops.local_attn import fused_tile_attention as j_fused_tile
from hicom_tpu.ops.pos_embed import get_3d_sincos_pos_embed as j_pos
from hicom_tpu.ops.resize import resize_thw as j_resize
from hicom_tpu_torch.ops import attention as tattn
from hicom_tpu_torch.ops import flash_attention as tfa
from hicom_tpu_torch.ops.flash_decode import flash_decode as t_flash_decode
from hicom_tpu_torch.ops.grouping import tile_thw as t_tile_thw
from hicom_tpu_torch.ops.local_attn import fused_tile_attention as t_fused_tile
from hicom_tpu_torch.ops.pos_embed import get_3d_sincos_pos_embed as t_pos
from hicom_tpu_torch.ops.resize import resize_thw as t_resize

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


# --------------------------------------------------------------------------- #
# K1 / K2: flash forward
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("bh,L,d", [(4, 729, 72), (4, 201, 72), (8, 93, 64)])
def test_k1_fullblock_twin_matches_pallas(bh, L, d):
    rng = np.random.default_rng(L)
    q, k, v = (_rand(rng, bh, L, d) for _ in range(3))
    ref, ref_lse = jfa._fullblock_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d**-0.5, 0.25, True)
    got, got_lse = tfa.fullblock_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                           d**-0.5, 0.25)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    # lse is a log of a sum of up to L terms: 1e-4 absolute covers its fp32 rounding
    np.testing.assert_allclose(_np(got_lse), _np(ref_lse), rtol=1e-4, atol=1e-4)
    # the public entry routes the tower shape to K1 as the JAX entry does
    jout = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=1024, block_k=1024,
                               interpret=True)
    tout = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               block_q=1024, block_k=1024)
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)


@pytest.mark.parametrize(
    "q_len,kv_len,causal,lens",
    [
        (100, 100, True, None),
        (300, 300, True, [217, 300]),
        (37, 729, False, None),
        (96, 96, False, [60, 96]),
        (64, 192, True, None),  # bottom-right diagonal, Lq != Lk
    ],
)
def test_k2_flash_twin_matches_pallas(q_len, kv_len, causal, lens):
    rng = np.random.default_rng(q_len + kv_len)
    b, h, d = 2, 2, 32
    q, k, v = _rand(rng, b, h, q_len, d), _rand(rng, b, h, kv_len, d), _rand(rng, b, h, kv_len, d)
    jl = jnp.asarray(lens, jnp.int32) if lens else None
    tl = torch.tensor(lens, dtype=torch.int32) if lens else None
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=causal, kv_lengths=jl,
                              block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), is_causal=causal,
                              kv_lengths=tl, block_q=64, block_k=64)
    ref, got = _np(ref), _np(got)
    if lens:  # padded query rows carry values nobody reads: compare valid rows
        valid = (np.arange(q_len)[None, :] < np.asarray(lens)[:, None])[:, None, :, None]
        ref, got = np.where(valid, ref, 0), np.where(valid, got, 0)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("L,S,lens", [(64, 192, None), (100, 100, [70, 100]), (241, 241, None)])
def test_k2_gqa_twin_matches_pallas(L, S, lens):
    rng = np.random.default_rng(L * 7 + S)
    b, KVH, g, d = 2, 2, 3, 32
    q = _rand(rng, b, KVH * g, L, d)
    k, v = _rand(rng, b, KVH, S, d), _rand(rng, b, KVH, S, d)
    jl = jnp.asarray(lens, jnp.int32) if lens else None
    tl = torch.tensor(lens, dtype=torch.int32) if lens else None
    ref = jfa.flash_attention_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True, kv_lengths=jl,
                                  block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention_gqa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), is_causal=True,
                                  kv_lengths=tl)
    ref, got = _np(ref), _np(got)
    if lens:
        valid = (np.arange(L)[None, :] < np.asarray(lens)[:, None])[:, None, :, None]
        ref, got = np.where(valid, ref, 0), np.where(valid, got, 0)
    np.testing.assert_allclose(got, ref, **TOL)


# --------------------------------------------------------------------------- #
# K3: decode
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("quantized", [False, True])
def test_k3_decode_twin_matches_pallas(quantized):
    rng = np.random.default_rng(3 + quantized)
    b, KVH, g, S, d = 2, 2, 4, 700, 32
    q = _rand(rng, b, KVH * g, 1, d)
    mask = rng.random((b, S)) < 0.6
    mask[:, 0] = True
    if quantized:
        k = rng.integers(-127, 128, (b, KVH, S, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, KVH, S, d)).astype(np.int8)
        ks = (rng.random((b, KVH, S)) * 0.02).astype(np.float32)
        vs = (rng.random((b, KVH, S)) * 0.02).astype(np.float32)
        ref = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                             k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
        got = t_flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask),
                             k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    else:
        # a bf16 cache: both sides take bf16 q/k/v, accumulate in fp32 and round p
        # and the output to bf16, so one bf16 ulp of an O(1) output (2^-7) bounds them
        qb, kb, vb = (x.astype(jnp.bfloat16) for x in (jnp.asarray(q), jnp.asarray(_rand(rng, b, KVH, S, d)),
                                                       jnp.asarray(_rand(rng, b, KVH, S, d))))
        ref = j_flash_decode(qb, kb, vb, jnp.asarray(mask), interpret=True)
        to_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
        got = t_flash_decode(to_t(qb), to_t(kb), to_t(vb), torch.from_numpy(mask))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(ref.astype(jnp.float32)), rtol=0, atol=2**-7)


# --------------------------------------------------------------------------- #
# K4: local tile attention
# --------------------------------------------------------------------------- #


def test_k4_tile_twin_matches_pallas():
    rng = np.random.default_rng(20)
    t, h, w, qk, dv = 8, 9, 9, 64, 48
    kt, kh, kw = 4, 3, 3
    key, val = _rand(rng, t, h, w, qk), _rand(rng, t, h, w, dv)
    q = _rand(rng, t // kt, h // kh, w // kw, qk)
    for scale, bias in ((1.0 / math.sqrt(qk), 0.0), (1.7, -0.3)):
        ref = j_fused_tile(jnp.asarray(q), jnp.asarray(key), jnp.asarray(val), (kt, kh, kw),
                           jnp.float32(scale), jnp.float32(bias), interpret=True)
        for s, bb in ((scale, bias), (torch.tensor(scale), torch.tensor(bias))):  # float and tensor scalars
            got = t_fused_tile(torch.from_numpy(q), torch.from_numpy(key), torch.from_numpy(val), (kt, kh, kw), s, bb)
            np.testing.assert_allclose(_np(got), _np(ref), **TOL)


# --------------------------------------------------------------------------- #
# the dispatcher and the plain sdpa path
# --------------------------------------------------------------------------- #


def _jax_route(monkeypatch, q, k, *, mask=None, scale=None, logit_bias=0.0, jit_scale=False, is_causal=False,
               kv_lengths=None):
    """The kernel JAX's sdpa runs when its backend reports a TPU: None for the
    einsum path, else "fullblock" (K1) or "flash" (K2), as ``_flash_fwd_impl``
    decides from the blocks it is given (its condition, on JAX's own padding)."""
    calls = []

    def fake(kind):
        def f(q, k, v, **kw):
            calls.append((kind, kw))
            return q
        return f

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jfa, "flash_attention", fake("flash"))
    monkeypatch.setattr(jfa, "flash_attention_gqa", fake("gqa"))
    qj, kj = jnp.zeros(q, jnp.float32), jnp.zeros(k, jnp.float32)
    if jit_scale:  # a traced scale, as the clip-scale path passes exp(logit_scale)
        jax.jit(lambda q, k, s: jattn.sdpa(q, k, k, scale=s))(qj, kj, jnp.float32(scale))
    else:
        jattn.sdpa(qj, kj, kj, mask=mask, scale=scale, logit_bias=logit_bias, is_causal=is_causal,
                   kv_lengths=kv_lengths)
    monkeypatch.undo()
    if not calls:
        return None
    kind, kw = calls[0]
    if kind == "gqa":
        return "flash"
    q3, k3 = jnp.zeros((1,) + q[-2:]), jnp.zeros((1,) + k[-2:])
    _, _, _, bq, bk, nq, nk = jfa._pad_to_blocks(q3, k3, k3, kw.get("block_q", jfa.DEFAULT_BLOCK_Q),
                                                 kw.get("block_k", jfa.DEFAULT_BLOCK_K))
    full_kv = kw["kv_lengths"] is None
    fullblock = full_kv and not kw["is_causal"] and nq == nk == 1 and nq * bq == q[-2] and nk * bk == k[-2]
    return "fullblock" if fullblock else "flash"


@pytest.mark.parametrize(
    "q,k,extra",
    [
        ((1, 16, 729, 72), (1, 16, 729, 72), {}),  # tower: full-block K1
        ((1, 28, 120, 128), (1, 4, 120, 128), {}),  # decoder prefill: grouped K2
        ((1, 9, 32, 128), (1, 9, 2000, 128), {}),  # global compressor: K2
        ((1, 4, 100, 72), (1, 2, 100, 72), {}),  # grouped, lane-misaligned: plain
        ((1, 16, 729, 72), (1, 16, 729, 72), {"mask": True}),  # explicit mask: plain
        ((1, 16, 1100, 72), (1, 16, 1100, 72), {}),  # beyond one block, d % 64 != 0: plain
        ((648, 1, 36), (648, 36, 36), {}),  # local tiles: too small, plain
        ((1, 9, 32, 128), (1, 9, 2000, 128), {"tensor_scale": True}),  # traced scale: plain
        ((2, 4, 300, 64), (2, 4, 300, 64), {}),  # lane-aligned d: K2 with default blocks
        ((2, 4, 200, 128), (2, 4, 200, 128), {}),  # one default block: K1
        ((1, 16, 729, 72), (1, 16, 729, 72), {"causal": True}),  # full blocks, causal: K2
        ((2, 4, 200, 128), (2, 4, 200, 128), {"lengths": True}),  # one block, kv lengths: K2
    ],
)
def test_dispatcher_matches_jax_auto_rule(monkeypatch, q, k, extra):
    mask_j = jnp.ones(q[:-1] + (k[-2],), bool) if extra.get("mask") else None
    mask_t = torch.ones(q[:-1] + (k[-2],), dtype=torch.bool) if extra.get("mask") else None
    causal = extra.get("causal", False)
    lens_j = jnp.full((q[0],), k[-2] - 1, jnp.int32) if extra.get("lengths") else None
    lens_t = torch.full((q[0],), k[-2] - 1, dtype=torch.int32) if extra.get("lengths") else None
    if extra.get("tensor_scale"):
        jr = _jax_route(monkeypatch, q, k, scale=0.5, jit_scale=True)
        tr = tattn.flash_route(q, k, scale=torch.tensor(0.5))
    else:
        jr = _jax_route(monkeypatch, q, k, mask=mask_j, is_causal=causal, kv_lengths=lens_j)
        tr = tattn.flash_route(q, k, mask=mask_t, is_causal=causal, kv_lengths=lens_t)
    assert tr == jr


@pytest.mark.parametrize("case", ["causal_lengths", "mask", "grouped_lengths", "tensor_scale", "lq_ne_lk"])
def test_plain_sdpa_matches_jax_einsum(case):
    rng = np.random.default_rng(len(case))
    b, H, KVH, L, S, d = 2, 4, 4, 24, 24, 16
    kw_j, kw_t = {}, {}
    if case == "grouped_lengths":
        KVH = 2
    if case == "lq_ne_lk":
        L, S = 8, 24
    q, k, v = _rand(rng, b, H, L, d), _rand(rng, b, KVH, S, d), _rand(rng, b, KVH, S, d)
    if case in ("causal_lengths", "grouped_lengths"):
        kw_j = dict(is_causal=True, kv_lengths=jnp.asarray([15, 24]))
        kw_t = dict(is_causal=True, kv_lengths=torch.tensor([15, 24]))
    elif case == "mask":
        m = rng.random((b, 1, L, S)) > 0.3
        m[..., 0] = True
        kw_j, kw_t = dict(mask=jnp.asarray(m)), dict(mask=torch.from_numpy(m))
    elif case == "tensor_scale":
        kw_j = dict(scale=jnp.float32(0.7), logit_bias=jnp.float32(-0.2))
        kw_t = dict(scale=torch.tensor(0.7), logit_bias=torch.tensor(-0.2))
    elif case == "lq_ne_lk":
        kw_j, kw_t = dict(is_causal=True), dict(is_causal=True)
    ref = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), implementation="einsum", **kw_j)
    got = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw_t)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


# --------------------------------------------------------------------------- #
# resize / tiling / position embedding
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("thw,out", [((32, 27, 27), (8, 9, 9)), ((5, 7, 4), (2, 3, 2)), ((1, 4, 4), (1, 2, 2))])
def test_resize_matches_jax_and_torch_interpolate(thw, out):
    rng = np.random.default_rng(sum(thw))
    x = _rand(rng, *thw, 6)
    ref = j_resize(jnp.asarray(x), out)
    got = t_resize(torch.from_numpy(x), out)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)
    # and torch's own trilinear (align_corners=False) on the same volume
    tri = torch.nn.functional.interpolate(torch.from_numpy(x).permute(3, 0, 1, 2)[None], size=out,
                                          mode="trilinear", align_corners=False)[0].permute(1, 2, 3, 0)
    np.testing.assert_allclose(_np(got), _np(tri), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("thw,kernel", [((8, 9, 9), (4, 3, 3)), ((6, 4, 5), (4, 3, 3)), ((5, 27, 27), (4, 3, 3)),
                                        ((2, 9, 9), (4, 3, 3)), ((2, 2, 7), (5, 3, 3))])
def test_tile_thw_matches_jax(thw, kernel):
    rng = np.random.default_rng(7)
    x = _rand(rng, *thw, 3)
    ref = j_tile_thw(jnp.asarray(x), kernel)
    got = t_tile_thw(torch.from_numpy(x)[None], kernel)[0]  # a leading batch axis passes through
    np.testing.assert_array_equal(_np(got), _np(ref))


def test_pos_embed_matches_jax():
    np.testing.assert_array_equal(t_pos(4, 3, 5, 16), j_pos(4, 3, 5, 16))
