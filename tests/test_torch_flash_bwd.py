"""The flash backward (K5 dQ, K6 dK/dV) of the port against the JAX package.

The port's plain twin ``flash_backward_reference``, and the autograd Function
that carries it, are held to ``jax.vjp`` of the JAX entry points with
``interpret=True``: JAX's custom VJP then runs the Pallas kernels
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` themselves. Inputs come from numpy
seeds and go to both packages. In fp32 the comparison is atol = rtol = 5e-5:
both sides compute the same fp32 arithmetic in another summation order, and a
gradient sums over up to a few hundred keys or queries (the forward tests'
2e-5, scaled for the longer sums). The cases cover every padded head dim that
K5/K6 have an instance for beside the decoder's 32 and 128 (16, 48, 96, 112),
in fp32 and in bf16; in bf16 both sides round P and dS to bf16 before their
products and the gradients to bf16 at the end, so each element is held to
``chip_smoke.BF16_GATE``: 2^-6 of its value (two bf16 ulps: the two round at
another running max and in another order) plus 2^-5 of the gradient's rms (a
sum of rounded terms near zero).

The split twins (``split_dq_reference``, ``split_dkv_reference`` and the
fp32 ``sum_partials_reference``), which describe the kernels' split paths in
both types, are held to the unsplit twin in fp32 at forced splits.

``torch.autograd.gradcheck`` holds the Function to finite differences of its
own forward in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hicom_tpu.ops import flash_attention as jfa
from hicom_tpu_torch.ops import attention as tattn
from hicom_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=5e-5, atol=5e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_grads(fn, q, k, v, do, dtype="float32"):
    jt = DTYPES[dtype][0]
    out, vjp = jax.vjp(fn, *(jnp.asarray(x, jt) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jt))]


def _port_grads(fn, q, k, v, do, dtype="float32"):
    tt = DTYPES[dtype][1]
    leaves = [torch.from_numpy(x).to(tt).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return [g.float().numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(do).to(tt))]


def _close(got, ref, dtype, what):
    """fp32: ``TOL``; bf16: every element within ``chip_smoke.BF16_GATE``."""
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, err_msg=what, **TOL)
        return
    err, ratio, rms, _ = chip_smoke.agreement(torch.tensor(np.asarray(got)), torch.tensor(np.asarray(ref)))
    assert ratio <= 1 and rms > 0, f"{what}: max err {err}, worst err/tol {ratio}"


CASES = {
    # name: (b, H, KVH, Lq, Lk, d, causal, lens, bias, gqa_entry)
    "causal_lq_ne_lk": (2, 2, 2, 64, 192, 32, True, None, 0.0, False),
    "kv_lengths": (2, 2, 2, 96, 96, 32, False, [60, 96], 0.0, False),
    "causal_lengths": (2, 2, 2, 100, 100, 32, True, [70, 100], 0.0, False),
    "logit_bias": (2, 2, 2, 40, 300, 32, False, None, 0.7, False),
    "gqa_causal_lengths": (2, 6, 2, 100, 100, 32, True, [70, 100], 0.0, True),
    "gqa_causal": (2, 6, 2, 64, 64, 32, True, None, -0.3, True),
}
# the head dims that pad to 16, 48, 96 and 112, each in fp32 and bf16 (the dtype ends the name)
for _dtype in DTYPES:
    CASES.update({f"d16_causal_lengths_{_dtype}": (2, 2, 2, 100, 100, 16, True, [70, 100], 0.0, False),
                  f"d48_kv_lengths_bias_{_dtype}": (2, 2, 2, 96, 96, 48, False, [60, 96], 0.3, False),
                  f"d96_gqa_causal_lengths_{_dtype}": (2, 6, 2, 100, 100, 96, True, [70, 100], 0.0, True),
                  f"d112_causal_lq_ne_lk_{_dtype}": (2, 2, 2, 64, 192, 112, True, None, 0.0, False)})
    CASES[f"d128_gqa_causal_{_dtype}"] = (2, 4, 2, 72, 72, 128, True, [72, 50], -0.2, True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_twin_matches_pallas_backward(case):
    b, H, KVH, Lq, Lk, d, causal, lens, bias, gqa = CASES[case]
    dtype = "bfloat16" if case.endswith("bfloat16") else "float32"
    tt = DTYPES[dtype][1]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _rand(rng, b, H, Lq, d), _rand(rng, b, KVH, Lk, d), _rand(rng, b, KVH, Lk, d)
    do = _rand(rng, b, H, Lq, d)
    jl = jnp.asarray(lens, jnp.int32) if lens else None
    tl = torch.tensor(lens, dtype=torch.int32) if lens else None
    entry = jfa.flash_attention_gqa if gqa else jfa.flash_attention
    ref = _jax_grads(lambda q, k, v: entry(q, k, v, is_causal=causal, kv_lengths=jl, logit_bias=bias,
                                           block_q=64, block_k=64, interpret=True), q, k, v, do, dtype)

    # the twin on the port's own forward (out, lse), called directly ...
    qt, kt, vt = (torch.from_numpy(x).to(tt) for x in (q, k, v))
    out, lse = tfa.flash_forward(qt, kt, vt, tl, d**-0.5, bias, causal)
    twin = tfa.flash_backward_reference(qt, kt, vt, tl, out, lse, torch.from_numpy(do).to(tt), d**-0.5, bias, causal)
    assert all(t.dtype == tt for t in twin)
    # ... and through the autograd Function of the public entry points
    port_entry = tfa.flash_attention_gqa if gqa else tfa.flash_attention
    port = _port_grads(lambda q, k, v: port_entry(q, k, v, is_causal=causal, kv_lengths=tl, logit_bias=bias,
                                                  block_q=64, block_k=64), q, k, v, do, dtype)
    for name, r, t, p in zip("qkv", ref, twin, port):
        _close(t.float().numpy(), r, dtype, f"d{name} (twin)")
        _close(p, r, dtype, f"d{name} (Function)")


@pytest.mark.parametrize("bh,L,d", [(4, 201, 72), (3, 128, 64), (2, 150, 16), (2, 140, 96), (2, 130, 48),
                                    (2, 129, 112)])
def test_fullblock_route_backward_matches_pallas(bh, L, d):
    """The tower's route: one whole block, no mask (K1 forward, ``full_kv``
    backward on the TPU), in fp32."""
    _fullblock_case(bh, L, d, "float32")


@pytest.mark.parametrize("d", [16, 48, 72, 96, 112])
def test_fullblock_route_backward_bf16_matches_pallas(d):
    """The same route in bf16 at the new widths and the tower's 72."""
    _fullblock_case(2, 137, d, "bfloat16")


def _fullblock_case(bh, L, d, dtype):
    rng = np.random.default_rng(bh * L + d)
    q, k, v, do = (_rand(rng, bh, L, d) for _ in range(4))
    blocks = dict(block_q=1024, block_k=1024)
    assert tfa.uses_fullblock(L, L, causal=False, has_lengths=False, block_q=1024, block_k=1024)
    ref = _jax_grads(lambda q, k, v: jfa.flash_attention(q, k, v, logit_bias=0.25, interpret=True, **blocks),
                     q, k, v, do, dtype)
    port = _port_grads(lambda q, k, v: tfa.flash_attention(q, k, v, logit_bias=0.25, **blocks), q, k, v, do, dtype)
    for name, r, p in zip("qkv", ref, port):
        _close(p, r, dtype, f"d{name}")


SPLIT_CASES = {
    # name: (b, H, KVH, Lq, Lk, d, causal, lens)
    "global_d16": (2, 3, 3, 32, 700, 16, False, None),  # 32-row query blocks, chunks of 32-key tiles
    "gqa_causal_lengths_d96": (2, 6, 2, 150, 150, 96, True, [150, 97]),  # empty chunks and ranges
    "causal_lq_ne_lk_d112": (1, 4, 4, 70, 200, 112, True, None),
}


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_twins_match_the_unsplit_twin_in_fp32(case, n_split):
    """The kernels' split paths in plain PyTorch (K5's key chunks, K6's unit
    ranges, then the sum pass in fp32, with no bf16 step) give the unsplit
    twin's gradients in fp32 within ``TOL``: the same sums in another order."""
    b, H, KVH, Lq, Lk, d, causal, lens = SPLIT_CASES[case]
    rng = np.random.default_rng(n_split + sum(map(ord, case)))
    q, k, v = (torch.from_numpy(_rand(rng, *s)) for s in ((b, H, Lq, d), (b, KVH, Lk, d), (b, KVH, Lk, d)))
    do = torch.from_numpy(_rand(rng, b, H, Lq, d))
    kl = torch.tensor(lens, dtype=torch.int32) if lens else None
    out, lse = tfa.flash_forward(q, k, v, kl, d**-0.5, 0.1, causal)
    dq, dk, dv = tfa.flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, 0.1, causal)
    sdq = tfa.split_dq_reference(q, k, v, kl, out, lse, do, d**-0.5, 0.1, causal, n_split)
    sdk, sdv = tfa.split_dkv_reference(q, k, v, kl, out, lse, do, d**-0.5, 0.1, causal, n_split)
    for name, got, want in (("dq", sdq, dq), ("dk", sdk, dk), ("dv", sdv, dv)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=name, **TOL)
    part = torch.from_numpy(_rand(rng, n_split, 3, 40))
    summed = tfa.sum_partials_reference(part, 0.125, torch.float32)
    assert summed.dtype == torch.float32 and torch.equal(summed, part.sum(dim=0) * 0.125)


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
