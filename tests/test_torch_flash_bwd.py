"""The flash backward (K5 dQ, K6 dK/dV) of the port against the JAX package.

The port's plain twin ``flash_backward_reference``, and the autograd Function
that carries it, are held to ``jax.vjp`` of the JAX entry points with
``interpret=True``: JAX's custom VJP then runs the Pallas kernels
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` themselves. Inputs come from numpy
seeds and go to both packages; the comparison is fp32 on the CPU with
atol = rtol = 5e-5: both sides compute the same fp32 arithmetic in another
summation order, and a gradient sums over up to a few hundred keys or
queries (the forward tests' 2e-5, scaled for the longer sums).

``torch.autograd.gradcheck`` holds the Function to finite differences of its
own forward in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu.ops import flash_attention as jfa
from hicom_tpu_torch.ops import attention as tattn
from hicom_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=5e-5, atol=5e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(fn, q, k, v, do):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(do))]


CASES = {
    # name: (b, H, KVH, Lq, Lk, d, causal, lens, bias, gqa_entry)
    "causal_lq_ne_lk": (2, 2, 2, 64, 192, 32, True, None, 0.0, False),
    "kv_lengths": (2, 2, 2, 96, 96, 32, False, [60, 96], 0.0, False),
    "causal_lengths": (2, 2, 2, 100, 100, 32, True, [70, 100], 0.0, False),
    "logit_bias": (2, 2, 2, 40, 300, 32, False, None, 0.7, False),
    "gqa_causal_lengths": (2, 6, 2, 100, 100, 32, True, [70, 100], 0.0, True),
    "gqa_causal": (2, 6, 2, 64, 64, 32, True, None, -0.3, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_twin_matches_pallas_backward(case):
    b, H, KVH, Lq, Lk, d, causal, lens, bias, gqa = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _rand(rng, b, H, Lq, d), _rand(rng, b, KVH, Lk, d), _rand(rng, b, KVH, Lk, d)
    do = _rand(rng, b, H, Lq, d)
    jl = jnp.asarray(lens, jnp.int32) if lens else None
    tl = torch.tensor(lens, dtype=torch.int32) if lens else None
    entry = jfa.flash_attention_gqa if gqa else jfa.flash_attention
    ref = _jax_grads(lambda q, k, v: entry(q, k, v, is_causal=causal, kv_lengths=jl, logit_bias=bias,
                                           block_q=64, block_k=64, interpret=True), q, k, v, do)

    # the twin on the port's own forward (out, lse), called directly ...
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = tfa.flash_forward(qt, kt, vt, tl, d**-0.5, bias, causal)
    twin = tfa.flash_backward_reference(qt, kt, vt, tl, out, lse, torch.from_numpy(do), d**-0.5, bias, causal)
    # ... and through the autograd Function of the public entry points
    port_entry = tfa.flash_attention_gqa if gqa else tfa.flash_attention
    port = _port_grads(lambda q, k, v: port_entry(q, k, v, is_causal=causal, kv_lengths=tl, logit_bias=bias,
                                                  block_q=64, block_k=64), q, k, v, do)
    for name, r, t, p in zip("qkv", ref, twin, port):
        np.testing.assert_allclose(t.numpy(), r, err_msg=f"d{name} (twin)", **TOL)
        np.testing.assert_allclose(p, r, err_msg=f"d{name} (Function)", **TOL)


@pytest.mark.parametrize("bh,L,d", [(4, 201, 72), (3, 128, 64)])
def test_fullblock_route_backward_matches_pallas(bh, L, d):
    """The tower's route: one whole block, no mask (K1 forward, ``full_kv``
    backward on the TPU)."""
    rng = np.random.default_rng(bh * L)
    q, k, v, do = (_rand(rng, bh, L, d) for _ in range(4))
    blocks = dict(block_q=1024, block_k=1024)
    assert tfa.uses_fullblock(L, L, causal=False, has_lengths=False, block_q=1024, block_k=1024)
    ref = _jax_grads(lambda q, k, v: jfa.flash_attention(q, k, v, logit_bias=0.25, interpret=True, **blocks),
                     q, k, v, do)
    port = _port_grads(lambda q, k, v: tfa.flash_attention(q, k, v, logit_bias=0.25, **blocks), q, k, v, do)
    for name, r, p in zip("qkv", ref, port):
        np.testing.assert_allclose(p, r, err_msg=f"d{name}", **TOL)


@pytest.fixture
def one_thread():
    """gradcheck runs thousands of tiny ops; with every test worker's intra-op
    threads sharing the cores they crawl (about 50x), so run them on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fullblock,causal,lens", [(False, True, [9, 6]), (False, False, [9, 9]),
                                                   (False, True, None), (True, False, None)])
def test_function_gradcheck_float64(fullblock, causal, lens, one_thread):
    rng = np.random.default_rng(5)
    b, H, KVH, Lq, Lk, d = (3, 1, 1, 10, 10, 8) if fullblock else (2, 4, 2, 7, 9, 8)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((b, H, Lq, d), (b, KVH, Lk, d), (b, KVH, Lk, d)))
    kl = torch.tensor(lens) if lens else None
    fn = lambda q, k, v: tfa.FlashAttention.apply(q, k, v, kl, 0.3, 0.1, causal, fullblock)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_run_kernel_is_differentiable_and_serving_saves_nothing(monkeypatch):
    """``sdpa``'s kernel route (``run_kernel``) carries the Function: on the
    grouped decoder shape its gradients equal those of ``sdpa``'s plain path,
    and under ``inference_mode`` the same call records no graph."""
    rng = np.random.default_rng(9)
    q, k, v = _rand(rng, 2, 6, 40, 64), _rand(rng, 2, 2, 40, 64), _rand(rng, 2, 2, 40, 64)
    do = _rand(rng, 2, 6, 40, 64)
    lens = torch.tensor([40, 31])
    plain = _port_grads(lambda q, k, v: tattn._sdpa_plain(q, k, v, scale=None, logit_bias=0.0, mask=None,
                                                          is_causal=True, kv_lengths=lens), q, k, v, do)
    calls = []
    real = tfa.FlashAttention.apply
    monkeypatch.setattr(tfa.FlashAttention, "apply", lambda *a: calls.append(1) or real(*a))
    kernel = _port_grads(lambda q, k, v: tfa.run_kernel("flash", q, k, v, scale=64**-0.5, logit_bias=0.0,
                                                        is_causal=True, kv_lengths=lens), q, k, v, do)
    assert calls
    for name, p, kk in zip("qkv", plain, kernel):
        np.testing.assert_allclose(kk, p, err_msg=f"d{name}", **TOL)
    calls.clear()
    with torch.inference_mode():
        out = tfa.run_kernel("flash", *(torch.from_numpy(x).requires_grad_() for x in (q, k, v)), scale=0.125,
                             logit_bias=0.0, is_causal=True, kv_lengths=lens)
    assert not calls and not out.requires_grad
