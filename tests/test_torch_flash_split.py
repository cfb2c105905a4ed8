"""The split-KV path of the flash forward (K1/K2) and of K5 (dQ) against the JAX package.

When a grid of one block per query tile cannot fill the card, the kernels cut
the key axis into chunks, write fp32 partials and merge (forward) or sum (dQ)
them in a second pass. ``split_forward_reference`` and ``split_dq_reference``
are that path in plain PyTorch, chunk by chunk over the kernels' own key tiles;
here they are held to the Pallas kernels in interpret mode on the CPU: the
forward to ``flash_attention``/``flash_attention_gqa`` at 2e-5 (the forward
tests' tolerance), dQ to ``jax.vjp`` of the same entries at 5e-5 (that of
``test_torch_flash_bwd.py``). Both sides compute fp32 arithmetic in another
summation order. The split counts 1, 2, 3 and 7 give even, uneven and empty
chunks; the cases give chunks wholly past ``kv_lengths``, a causal Lq != Lk,
and chunks whose tiles are all masked for some rows (above their diagonal),
which must lose the merge.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu.ops import flash_attention as jfa
from hicom_tpu_torch.ops import flash_attention as tfa

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
DQ_TOL = dict(rtol=5e-5, atol=5e-5)
SPLITS = (1, 2, 3, 7)

CASES = {
    # name: (b, H, KVH, Lq, Lk, d, causal, lens, bias)
    # b 0 has 2 key tiles of 64: with 3 or 7 chunks some walk nothing (wholly past kv_lengths)
    "lengths": (2, 4, 4, 37, 130, 32, False, [100, 130], 0.0),
    # bottom-right diagonal with Lq != Lk
    "causal_lq_ne_lk": (2, 2, 2, 64, 192, 32, True, None, 0.3),
    # rows 128-191 of the second query block see no key of its last tile (keys 192-255): that
    # chunk's tiles are all masked for them and must weigh 0 against their real maxima
    "causal_lengths_masked_chunk": (2, 2, 2, 300, 300, 32, True, [217, 300], 0.0),
    # grouped query heads, the global compressor's few queries over many keys
    "gqa_long_kv": (1, 6, 2, 32, 900, 32, False, None, -0.2),
}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs from a numpy seed, and JAX's output and dQ for them (Pallas in interpret mode)."""
    b, H, KVH, Lq, Lk, d, causal, lens, bias = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, do = _rand(rng, b, H, Lq, d), _rand(rng, b, KVH, Lk, d), _rand(rng, b, KVH, Lk, d), _rand(rng, b, H, Lq, d)
    jl = jnp.asarray(lens, jnp.int32) if lens else None
    entry = jfa.flash_attention_gqa if H != KVH else jfa.flash_attention

    def fn(q, k, v):
        return entry(q, k, v, is_causal=causal, kv_lengths=jl, logit_bias=bias, block_q=64, block_k=64, interpret=True)

    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (q, k, v, do), np.asarray(out), np.asarray(vjp(jnp.asarray(do))[0])


def _torch(name):
    (q, k, v, do), _, _ = _case(name)
    lens = CASES[name][7]
    return tuple(torch.from_numpy(x) for x in (q, k, v, do)) + (torch.tensor(lens) if lens else None,)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_forward_matches_pallas(name, n_split):
    b, H, KVH, Lq, Lk, d, causal, lens, bias = CASES[name]
    q, k, v, _, kl = _torch(name)
    _, ref, _ = _case(name)
    out, lse = tfa.split_forward_reference(q, k, v, kl, d**-0.5, bias, causal, n_split)
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)
    # the merged lse is the whole row's: the plain twin's, to fp32 rounding of a log-sum-exp
    _, ref_lse = tfa.flash_reference(q, k, v, kl, d**-0.5, bias, causal)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_dq_matches_pallas_backward(name, n_split):
    b, H, KVH, Lq, Lk, d, causal, lens, bias = CASES[name]
    q, k, v, do, kl = _torch(name)
    _, _, ref_dq = _case(name)
    out, lse = tfa.flash_reference(q, k, v, kl, d**-0.5, bias, causal)
    dq = tfa.split_dq_reference(q, k, v, kl, out, lse, do, d**-0.5, bias, causal, n_split)
    np.testing.assert_allclose(dq.numpy(), ref_dq, **DQ_TOL)


@pytest.mark.parametrize("n_split", (2, 7))
@pytest.mark.parametrize("causal,lens", [(True, None), (False, [0, 70])])
def test_split_forward_rows_without_keys_match_the_twin(causal, lens, n_split):
    """Rows with no valid key (causal with Lq > Lk: the first 40 rows; a
    zero kv length) end as the twin's mean of all values, however split."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, *s)) for s in ((2, 2, 100, 32), (2, 2, 60, 32), (2, 2, 60, 32)))
    kl = torch.tensor(lens) if lens else None
    ref, ref_lse = tfa.flash_reference(q, k, v, kl, 0.2, 0.0, causal)
    out, lse = tfa.split_forward_reference(q, k, v, kl, 0.2, 0.0, causal, n_split)
    torch.testing.assert_close(out, ref, **FWD_TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


def test_merge_weighs_empty_and_masked_chunks_zero():
    """A chunk with max -inf (no tile) and one with max -1e30 (all masked,
    p = 1 on every key) add nothing beside a chunk with a real maximum; a
    row whose chunks are all masked averages them by their counts."""
    o = torch.tensor([[[1.0, 2.0, 3.0, 4.0], [0.5, 0.5, 0.5, 0.5]],
                      [[7.0, 7.0, 7.0, 7.0], [3.0, 3.0, 3.0, 3.0]],
                      [[0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0]]])
    m = torch.tensor([[0.5, tfa.NEG_INF], [tfa.NEG_INF, tfa.NEG_INF], [float("-inf"), float("-inf")]])
    l = torch.tensor([[2.0, 1.0], [5.0, 3.0], [0.0, 0.0]])
    out, lse = tfa.merge_partials_reference(o, m, l, torch.float32)
    torch.testing.assert_close(out[0], o[0, 0] / 2.0)
    torch.testing.assert_close(out[1], (o[0, 1] + o[1, 1]) / 4.0)
    torch.testing.assert_close(lse[0], torch.tensor(0.5 + np.log(2.0), dtype=torch.float32))
    torch.testing.assert_close(tfa.sum_partials_reference(o, 0.5, torch.float32), o.sum(0) * 0.5)


@pytest.mark.parametrize("b", [1, 2])
def test_split_rules(b):
    # one split where one block per query tile fills the card: the decoder prefill and the tower
    assert tfa.forward_splits(b, 28, 743, 743) == 1 and tfa.dq_splits(b, 28, 743, 743) == 1
    for rows in (32 * 16 * b, 64 * 16):
        assert tfa.forward_splits(rows, 1, 729, 729) == 1 and tfa.dq_splits(rows, 1, 729, 729) == 1
    # at least one wave of blocks at the global compressor's shape
    fwd, dq = tfa.forward_splits(b, 9, 32, 23328), tfa.dq_splits(b, 9, 32, 23328)
    assert b * 9 * fwd >= tfa.H100_SMS and b * 9 * dq >= tfa.H100_SMS
    # never more splits than key tiles
    for lq in (1, 32, 100):
        for lk in (1, 63, 64, 65, 130, 1000, 23328):
            for heads in (1, 9, 28):
                assert 1 <= tfa.forward_splits(b, heads, lq, lk) <= -(-lk // tfa.FWD_BLOCK_K)
                assert 1 <= tfa.dq_splits(b, heads, lq, lk) <= -(-lk // tfa.DQ_BLOCK_K)
