"""K6's split path (dK/dV) and K3's chunked decode path against the JAX package.

K6 cuts each block's walk over its (query head, query tile) units into
ranges when its grid cannot fill the card, and sums the ranges' fp32 partials
in a second pass; ``split_dkv_reference`` is that path in plain PyTorch, held
here to ``jax.vjp`` of the Pallas backward in interpret mode at 5e-5 (the
tolerance of ``test_torch_flash_bwd.py``: the same fp32 arithmetic in another
summation order, over up to a few hundred queries). The split counts 1, 2, 3
and 7 give even, uneven and empty ranges; the cases give causal GQA with
lengths (a key tile wholly past ``kv_lengths``), a causal Lq != Lk, G = 1 with
lengths, and few queries over many keys.

K3 splits the cache into 32-slot chunks, one warp each, skips chunks with no
valid slot and merges the rest; ``chunked_decode_reference`` is that path,
held to the Pallas decode kernel in interpret mode at 2e-5 (the forward
tests' tolerance: fp32 sums over 256 slots in another order) for a float and
an int8 cache, with valid slots ending inside a chunk, with empty chunks, and
with a row whose bitmap is all clear.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu.ops import flash_attention as jfa
from hicom_tpu.ops.flash_decode import flash_decode as j_flash_decode
from hicom_tpu_torch.ops import cuda_build
from hicom_tpu_torch.ops import flash_attention as tfa
from hicom_tpu_torch.ops import flash_decode as tfd

DKV_TOL = dict(rtol=5e-5, atol=5e-5)
DECODE_TOL = dict(rtol=2e-5, atol=2e-5)
SPLITS = (1, 2, 3, 7)

CASES = {
    # name: (b, H, KVH, Lq, Lk, d, causal, lens, bias)
    # 3 heads per kv head, 3 query and key tiles; b 0's last key tile (keys 128-129) is past its length
    "gqa_causal_lengths": (2, 6, 2, 130, 130, 32, True, [90, 130], 0.0),
    # bottom-right diagonal with Lq != Lk, one query tile: 7 splits leave empty ranges
    "causal_lq_ne_lk": (2, 2, 2, 64, 192, 32, True, None, 0.3),
    # G = 1, b 0's third key tile wholly past kv_lengths
    "g1_lengths": (2, 2, 2, 100, 130, 32, False, [100, 130], -0.2),
    # the global compressor's few queries over many keys, grouped
    "gqa_long_kv": (1, 6, 2, 32, 300, 32, False, None, 0.0),
}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs from a numpy seed, and JAX's dK and dV for them (Pallas in interpret mode)."""
    b, H, KVH, Lq, Lk, d, causal, lens, bias = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, do = _rand(rng, b, H, Lq, d), _rand(rng, b, KVH, Lk, d), _rand(rng, b, KVH, Lk, d), _rand(rng, b, H, Lq, d)
    jl = jnp.asarray(lens, jnp.int32) if lens else None
    entry = jfa.flash_attention_gqa if H != KVH else jfa.flash_attention

    def fn(q, k, v):
        return entry(q, k, v, is_causal=causal, kv_lengths=jl, logit_bias=bias, block_q=64, block_k=64, interpret=True)

    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, dk, dv = vjp(jnp.asarray(do))
    return (q, k, v, do), np.asarray(dk), np.asarray(dv)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_dkv_matches_pallas_backward(name, n_split):
    b, H, KVH, Lq, Lk, d, causal, lens, bias = CASES[name]
    (q, k, v, do), ref_dk, ref_dv = _case(name)
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    kl = torch.tensor(lens) if lens else None
    out, lse = tfa.flash_reference(q, k, v, kl, d**-0.5, bias, causal)
    dk, dv = tfa.split_dkv_reference(q, k, v, kl, out, lse, do, d**-0.5, bias, causal, n_split)
    np.testing.assert_allclose(dk.numpy(), ref_dk, err_msg="dk", **DKV_TOL)
    np.testing.assert_allclose(dv.numpy(), ref_dv, err_msg="dv", **DKV_TOL)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("lk,lq,causal,limit,g", [(743, 743, True, 700, 7), (130, 37, False, 100, 1),
                                                  (192, 64, True, 192, 3), (60, 100, True, 60, 2)])
def test_dkv_unit_ranges_cover_every_unit_once(lk, lq, causal, limit, g, n_split):
    """Each block's chunks tile its units [0, g * nq) in order, and a block of
    keys wholly past the limit has none."""
    for k0 in range(0, lk, tfa.DKV_BLOCK_K):
        ranges = [tfa.dkv_unit_range(k0, lq, lk, limit, causal, g, s, n_split) for s in range(n_split)]
        qt_begin, nq = ranges[0][:2]
        assert all(r[:2] == (qt_begin, nq) for r in ranges)
        assert [r[2] for r in ranges] == [0] + [r[3] for r in ranges[:-1]] and ranges[-1][3] == g * nq
        if k0 >= limit:
            assert nq == 0
        elif causal:  # the first tile holds a query that sees key k0, the one before none
            assert (qt_begin + 1) * tfa.DKV_BLOCK_Q - 1 + lk - lq >= k0
            assert qt_begin == 0 or qt_begin * tfa.DKV_BLOCK_Q - 1 + lk - lq < k0


@pytest.mark.parametrize("b", [1, 2])
def test_dkv_split_rule(b):
    # the decoder prefill: 12 key tiles x b * 4 kv heads do not fill the card; the split brings at
    # least two blocks per SM's worth of work (192 blocks at b 2)
    n = tfa.dkv_splits(b, 28, 4, 743, 743, d=128)
    assert -(-743 // tfa.DKV_BLOCK_K) * b * 4 * n >= 192 and n <= 7 * 12
    # the global compressor (365 key tiles x b * 9 heads) and the tower (512 rows) fill it alone
    assert tfa.dkv_splits(b, 9, 9, 32, 23328, d=128) == 1 and tfa.dkv_splits(512 * b, 1, 1, 729, 729, d=72) == 1
    # never more splits than a block has units
    for lq, lk, heads, kvh in ((32, 64, 1, 1), (1, 64, 7, 1), (100, 700, 28, 4)):
        assert 1 <= tfa.dkv_splits(b, heads, kvh, lq, lk, d=128) <= heads // kvh * -(-lq // tfa.DKV_BLOCK_Q)


def _decode_inputs(rng, quantized, bitmap):
    b, KVH, g, S, d = 2, 2, 4, 256, 32
    q = _rand(rng, b, KVH * g, 1, d)
    slot = np.arange(S)
    mask = {
        # valid slots ending inside a chunk (75 = 2 chunks + 11), then empty chunks
        "ends_mid_chunk": np.stack([slot < 75, slot < 200]),
        # scattered slots: chunks of every fill, some empty
        "ragged": rng.random((b, S)) < np.where(slot < 128, 0.5, 0.05),
        # the second row has no valid slot: the uniform average of its values
        "all_clear_row": np.stack([slot < 150, np.zeros(S, bool)]),
    }[bitmap]
    mask[0, 0] = True
    if quantized:
        k = rng.integers(-127, 128, (b, KVH, S, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, KVH, S, d)).astype(np.int8)
        ks = (rng.random((b, KVH, S)) * 0.02).astype(np.float32)
        vs = (rng.random((b, KVH, S)) * 0.02).astype(np.float32)
    else:
        k, v, ks, vs = _rand(rng, b, KVH, S, d), _rand(rng, b, KVH, S, d), None, None
    return q, k, v, mask, ks, vs


@pytest.mark.parametrize("bitmap", ["ends_mid_chunk", "ragged", "all_clear_row"])
@pytest.mark.parametrize("quantized", [False, True])
def test_chunked_decode_matches_pallas(quantized, bitmap):
    rng = np.random.default_rng(11 + quantized)
    q, k, v, mask, ks, vs = _decode_inputs(rng, quantized, bitmap)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    ref = j_flash_decode(j(q), j(k), j(v), j(mask), k_scale=j(ks), v_scale=j(vs), interpret=True)
    got = tfd.chunked_decode_reference(t(q), t(k), t(v), t(mask), t(ks), t(vs), q.shape[-1] ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DECODE_TOL)
    # the plain twin that CPU tensors take gives the same answer
    twin = tfd.flash_decode(t(q), t(k), t(v), t(mask), k_scale=t(ks), v_scale=t(vs))
    np.testing.assert_allclose(got.numpy(), twin.numpy(), **DECODE_TOL)


def test_cuda_build_rebuilds_when_an_included_header_changes(tmp_path, monkeypatch):
    """The library's name hashes the source and the headers it includes, so an
    edited header builds a new library instead of loading a stale one."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint main() {}\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "unused.cuh").write_text("// not included\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    assert [p.name for p in cuda_build._sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = cuda_build._target("k")
    (tmp_path / "unused.cuh").write_text("// edited\n")
    assert cuda_build._target("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = cuda_build._target("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint main() { return 0; }\n')
    assert cuda_build._target("k") not in (first, second)
