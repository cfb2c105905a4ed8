"""K4, the local compressor's tile attention: the port's plain versions and route against the JAX package.

``tile_reference`` (the wrapper's CPU path) and ``chunked_tile_reference``
(the kernel's order of summation) are held to the Pallas kernel
``hicom_tpu/ops/local_attn.py:fused_tile_attention`` run with
``interpret=True``, in fp32 on the CPU, at the tolerance ``TOL`` of
``tests/test_torch_ops.py`` (2e-5 absolute and relative: fp32 sums of at most
64 terms taken in another order). ``LocalCompressor`` is held to the JAX
module on both of its routes, weights carried by ``state_dict_from_jax``
(1e-4, as ``tests/test_torch_towers.py`` holds the projector).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicom_tpu import config as jcfg
from hicom_tpu.models.projector import LocalCompressor as JLocal
from hicom_tpu.ops.local_attn import fused_tile_attention as j_fused_tile
from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models import projector as tprojector
from hicom_tpu_torch.models.projector import LocalCompressor as TLocal
from hicom_tpu_torch.ops.local_attn import (chunked_tile_reference, fused_tile_attention, takes_tile_kernel,
                                            tile_reference)
from hicom_tpu_torch.weights import state_dict_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_torch_ops.py
MODULE_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_towers.py

PLAIN = {"tile_reference": tile_reference, "chunked_tile_reference": chunked_tile_reference,
         "fused_tile_attention": fused_tile_attention}


def _scalars(form, scale, bias):
    """The scale and bias as the JAX call gets them and as the port's call gets them."""
    if form == "float":
        return (np.float32(scale), np.float32(bias)), (scale, bias)
    dtype = {"tensor": torch.float32, "bf16 tensor": torch.bfloat16}[form]
    s, b = torch.tensor(scale, dtype=dtype), torch.tensor(bias, dtype=dtype)
    return (np.float32(s.float().item()), np.float32(b.float().item())), (s, b)


@pytest.mark.parametrize("plain", sorted(PLAIN))
@pytest.mark.parametrize("form", ["float", "tensor", "bf16 tensor"])
@pytest.mark.parametrize("thw,kernel,qk,dv", [
    ((8, 9, 9), (4, 3, 3), 64, 64),  # the video tile, K = 36
    ((1, 9, 12), (1, 3, 3), 32, 32),  # the image tile (t = 1, kt = 1)
    ((4, 6, 4), (2, 2, 2), 16, 24),  # qk != dv
])
def test_plain_paths_match_pallas(thw, kernel, qk, dv, form, plain):
    rng = np.random.default_rng(sum(thw) + qk + dv)
    t, h, w = thw
    kt, kh, kw = kernel
    key = rng.standard_normal((t, h, w, qk)).astype(np.float32)
    val = rng.standard_normal((t, h, w, dv)).astype(np.float32)
    q = rng.standard_normal((t // kt, h // kh, w // kw, qk)).astype(np.float32)
    (js, jb), (ts, tb) = _scalars(form, 1.7 / math.sqrt(qk), -0.3)
    ref = j_fused_tile(jnp.asarray(q), jnp.asarray(key), jnp.asarray(val), kernel, js, jb, interpret=True)
    got = PLAIN[plain](torch.from_numpy(q), torch.from_numpy(key), torch.from_numpy(val), kernel, ts, tb)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("plain", sorted(PLAIN))
def test_batch_folded_into_frames_matches_pallas_per_sample(plain):
    # the projector folds (b, t) into one frame axis: tiles never cross samples when t % kt == 0
    rng = np.random.default_rng(7)
    b, t, h, w, qk, dv, kernel = 3, 8, 6, 9, 24, 40, (4, 3, 3)
    key = rng.standard_normal((b, t, h, w, qk)).astype(np.float32)
    val = rng.standard_normal((b, t, h, w, dv)).astype(np.float32)
    q = rng.standard_normal((b, t // 4, h // 3, w // 3, qk)).astype(np.float32)
    ref = np.stack([np.asarray(j_fused_tile(jnp.asarray(q[i]), jnp.asarray(key[i]), jnp.asarray(val[i]), kernel,
                                            np.float32(0.2), np.float32(0.1), interpret=True)) for i in range(b)])
    got = PLAIN[plain](torch.from_numpy(q).reshape(b * t // 4, h // 3, w // 3, qk),
                       torch.from_numpy(key).reshape(b * t, h, w, qk), torch.from_numpy(val).reshape(b * t, h, w, dv),
                       kernel, 0.2, 0.1)
    np.testing.assert_allclose(got.reshape(ref.shape).numpy(), ref, **TOL)


def test_plain_paths_round_p_like_the_kernel_in_bf16():
    # bf16 inputs: both plain paths round p and the output to bf16; they differ only in the
    # order of the fp32 sums, so by at most a bf16 ulp of the output
    rng = np.random.default_rng(11)
    key, val = (torch.from_numpy(rng.standard_normal((8, 9, 9, 64)).astype(np.float32)).bfloat16() for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((2, 3, 3, 64)).astype(np.float32)).bfloat16()
    a = tile_reference(q, key, val, (4, 3, 3), 0.125, 0.0)
    c = chunked_tile_reference(q, key, val, (4, 3, 3), 0.125, 0.0)
    assert a.dtype == c.dtype == torch.bfloat16
    ulp = 2.0 ** (torch.floor(torch.log2(a.float().abs().clamp_min(2**-20))) - 7)
    assert bool(((a.float() - c.float()).abs() <= ulp).all())


@pytest.mark.parametrize("thw,qk,dv,kernel,takes", [
    ((32, 27, 27), 1152, 1152, (4, 3, 3), True),  # the video, one request (b folds into t)
    ((64, 27, 27), 1152, 1152, (4, 3, 3), True),  # the batched request's folded frames
    ((1, 27, 27), 1152, 1152, (1, 3, 3), True),  # an image
    ((8, 9, 9), 64, 48, (4, 3, 3), True),  # qk != dv
    ((4, 4, 4), 64, 64, (4, 3, 3), False),  # overlapping windows: h % 3 != 0
    ((30, 27, 27), 1152, 1152, (4, 3, 3), False),  # t % kt != 0
    ((8, 30, 30), 64, 64, (2, 6, 6), False),  # K = 72 > 64
    ((8, 9, 9), 1150, 1152, (4, 3, 3), False),  # qk % 8 != 0
    ((8, 9, 9), 64, 12, (4, 3, 3), False),  # dv % 8 != 0
    ((1, 8, 64), 512, 512, (1, 1, 64), False),  # a 64-row segment: 64 KB, past one ring slot
    ((4, 3, 3), 16384, 16384, (1, 1, 1), False),  # wider than the kernel's 8192 columns
])
def test_route_predicate(thw, qk, dv, kernel, takes):
    assert takes_tile_kernel(thw, qk, dv, kernel) is takes


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(5)
    key, val = (torch.from_numpy(rng.standard_normal((4, 6, 6, 16)).astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((1, 2, 2, 16)).astype(np.float32))
    before = fused_tile_attention.launches
    out = fused_tile_attention(q, key, val, (4, 3, 3), 0.25, 0.5)
    assert fused_tile_attention.launches == before
    assert torch.equal(out, tile_reference(q, key, val, (4, 3, 3), 0.25, 0.5))
    with pytest.raises(ValueError, match="divisible"):
        fused_tile_attention(q, key[:, :5], val[:, :5], (4, 3, 3), 0.25, 0.5)


# --------------------------------------------------------------------------- #
# LocalCompressor on both routes
# --------------------------------------------------------------------------- #

CASES = {
    "direct": dict(use_guide="direct"),
    "direct qk 40": dict(use_guide="direct", projector_qk_dim=40),  # qk != dv
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("route,thw", [
    ("tile kernel", (8, 9, 9)),  # takes_tile_kernel holds, grad mode off: fused_tile_attention (plain on the CPU)
    ("gradient", (8, 9, 9)),  # grad mode on: tile_thw + sdpa
    ("overlap", (4, 4, 4)),  # overlapping windows: tile_thw + sdpa
])
def test_local_compressor_matches_jax_on_both_routes(monkeypatch, case, route, thw):
    kw = CASES[case]
    cj, ct = jcfg.tiny_test_config(**kw), tcfg.tiny_test_config(**kw)
    spec_j, spec_t = cj.projector.local, ct.projector.local
    rng = np.random.default_rng(len(case) + sum(thw))
    b, d, qk = 2, cj.mm_hidden_size, cj.qk_dim
    ff = rng.standard_normal((b, *thw, d)).astype(np.float32)
    fe = rng.standard_normal((b, *thw, qk)).astype(np.float32)
    ge = rng.standard_normal((b, qk)).astype(np.float32) if kw["use_guide"] else None
    jm = JLocal(spec=spec_j, qk_dim=qk, encoder_hidden_size=d, output_hidden_size=cj.hidden_size,
                use_guide=kw["use_guide"])
    # the JAX module's Pallas route in interpret mode where the port takes the tile kernel
    monkeypatch.setenv("HICOM_FUSED_LOCAL", "interpret" if route == "tile kernel" else "0")
    args = lambda i: (jnp.asarray(ff[i]), jnp.asarray(fe[i]), None if ge is None else jnp.asarray(ge[i]))  # noqa: E731
    params = jm.init(jax.random.PRNGKey(3), *args(0))["params"]
    ref = np.stack([np.asarray(jm.apply({"params": params}, *args(i))) for i in range(b)])

    tm = TLocal(spec_t, qk, d, ct.hidden_size, kw["use_guide"], dtype=torch.float32)
    sd = state_dict_from_jax({"mm_projector": {"local_compressor": jax.device_get(params)}})
    prefix = "model.mm_projector.local_compressor."
    tm.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}, strict=True)
    calls = []
    monkeypatch.setattr(tprojector, "fused_tile_attention",
                        lambda *a, **k: calls.append(1) or fused_tile_attention(*a, **k))
    inputs = (torch.from_numpy(ff), torch.from_numpy(fe), None if ge is None else torch.from_numpy(ge))
    with torch.set_grad_enabled(route == "gradient"):
        got = tm(*inputs)
    assert len(calls) == (route == "tile kernel")
    assert got.requires_grad == (route == "gradient")
    np.testing.assert_allclose(got.detach().numpy(), ref, **MODULE_TOL)
