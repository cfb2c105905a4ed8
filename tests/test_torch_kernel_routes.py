"""The kernels' contracts and the routes that read them, asked about the card.

Each kernel family has one predicate of its contract, beside its wrapper:
``takes_flash_kernel`` (K1/K2, and K5/K6 behind them), ``takes_decode_kernel``
(K3) and ``takes_tile_kernel`` (K4, its tiling; the wrapper checks the types).
The wrappers' checks read them and raise for device operands outside them.
Only K3 has a route on its contract: the decoder asks ``takes_decode_kernel``
before a one-token step and takes the plain masked attention for the rest
(JAX's default decode, on XLA), counted in ``cuda_build.plain_route``. The
other callers (``ops/attention.sdpa`` by JAX's ``auto`` rule, the split-key
partials and merge, the projector's local compressor by its tiling) launch
the kernel wherever JAX launches its Pallas kernel: K1/K2, the merge and K4
take fp32 as well as bf16, and K1/K2 (and K5/K6 behind them) every head dim
that is a multiple of 8, with no upper limit, as JAX's dtype-generic kernels
do: an fp32 gradient launches ``flash_bwd_f32.cu``, a bf16 one
``flash_bwd.cu``'s instance of its width, and past 256 the wide kernels of
``flash_wide.cu`` / ``flash_wide_f32.cu``. What no kernel takes raises in its
wrapper: fp16, mixed dtypes and a head dim that is not a multiple of 8, and
(in ``attend``, before the forward) a gradient of such attention, naming the
K5/K6 instance it lacks.

The routes are driven on meta tensors, which take every wrapper's device
branch (the CPU branch is for CPU tensors alone) through all its checks, with
the launch itself stubbed: a wrapper that would raise on the card raises here,
and a launch counts as it would there. No JAX: the routes' arithmetic is
held to JAX by the other ``test_torch_*`` files.
"""

import dataclasses
import types

import pytest
import torch

from hicom_tpu_torch import config as tcfg
from hicom_tpu_torch.models import qwen2
from hicom_tpu_torch.models.projector import LocalCompressor
from hicom_tpu_torch.ops import attention
from hicom_tpu_torch.ops import flash_attention as tfa
from hicom_tpu_torch.ops import flash_decode as tfd
from hicom_tpu_torch.ops import local_attn as tla
from hicom_tpu_torch.ops.cuda_build import plain_route

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def probe(monkeypatch):
    """Stub the launches (the C functions, the SM count, the stream) so that
    wrappers run to their end on meta tensors; returns a function giving the
    launches and plain-route counts since the fixture began. The C symbols
    asked for are kept in ``probe.symbols``."""
    symbols = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for mod in (tfa, tfd, tla):
        monkeypatch.setattr(mod, "c_function", lambda name, symbol, *a, **k: symbols.append(symbol) or (lambda *args: 0))
    for mod in (tfa, tla):
        monkeypatch.setattr(mod, "_sm_count", lambda index: 132)
    wrappers = {"K1": tfa.fullblock_attention, "K2": tfa.flash_forward, "K3": tfd.flash_decode,
                "K4": tla.fused_tile_attention, "merge": tfa.merge_partials, "K5/K6": tfa.flash_backward}
    before = {k: f.launches for k, f in wrappers.items()}
    plain_route.reset()

    def counts():
        launched = {k: f.launches - before[k] for k, f in wrappers.items()}
        return {k: n for k, n in launched.items() if n}, {k: n for k, n in plain_route.counts.items() if n}

    counts.symbols = symbols
    yield counts
    plain_route.reset()


def meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


# --------------------------------------------------------------------------- #
# the predicates
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("d,dtypes,takes", [
    (72, (BF16,) * 3, True),  # so400m
    (64, (BF16,) * 3, True),  # CLIP-L, Qwen2.5-0.5B
    (128, (BF16,) * 3, True),  # Qwen2.5-1.5B to 72B, the global compressor
    (32, (BF16,) * 3, True),
    (72, (F32,) * 3, True),  # so400m in fp32: flash_fwd_f32.cu
    (128, (BF16, BF16, F32), False),  # mixed dtypes
    (16, (BF16,) * 3, True),  # the selftest's decoder
    (96, (BF16,) * 3, True),  # pads to 96
    (136, (BF16,) * 3, True),  # past 128: the 192 instance on zero columns (JAX's rule: one block only)
    (192, (BF16,) * 3, True),  # JAX's d % 64 rule at any length
    (256, (BF16,) * 3, True),
    (192, (F32,) * 3, True),
    (256, (F32,) * 3, True),
    (264, (BF16,) * 3, True),  # past 256: the wide kernels (flash_wide.cu), head dim a runtime argument
    (264, (F32,) * 3, True),  # ... and flash_wide_f32.cu
    (512, (BF16,) * 3, True),  # JAX's d % 64 rule at any length: 320, 384, 512, ...
    (2048, (F32,) * 3, True),
    (16, (F32,) * 3, True),
    (112, (F32,) * 3, True),
    (72, (torch.float16,) * 3, False),
    (36, (BF16,) * 3, False),  # d % 8 != 0
])
def test_flash_contract(d, dtypes, takes):
    assert tfa.takes_flash_kernel(d, dtypes, "cuda") is takes
    assert tfa.takes_flash_kernel(d, dtypes, "cpu")  # the plain twins take anything


@pytest.mark.parametrize("d,dtype,takes", [(128, BF16, True), (72, BF16, True), (128, F32, True), (6, BF16, False),
                                           (72, F32, True), (128, torch.float16, False)])
def test_merge_contract(probe, d, dtype, takes):
    """The merge kernel takes fp32 partials of any head dim that is a
    multiple of 4 and writes rows of the caller's dtype itself, bf16 or fp32
    (no bf16 step before an fp32 row); another head dim or dtype raises on a
    device."""
    parts = meta(2, 4, d, dtype=F32), meta(2, 4, dtype=F32), meta(2, 4, dtype=F32)
    if takes:
        out, lse = tfa.merge_partials(*parts, dtype)
        assert out.shape == (4, d) and out.dtype == dtype and lse.shape == (4,) and lse.dtype == F32
    else:
        with pytest.raises(ValueError if d % 4 else TypeError, match="d % 4" if d % 4 else "float32"):
            tfa.merge_partials(*parts, dtype)
    assert probe() == ({"merge": 1} if takes else {}, {})


@pytest.mark.parametrize("b,H,KVH,S,d,q_dtype,cache_dtype,takes", [
    # every K3 row of PERF.md's table: 7B at b 1 and 2, the anyres cache, the engine, a tp-2 rank's heads
    (1, 28, 4, 4096, 128, BF16, BF16, True),
    (2, 28, 4, 4096, 128, BF16, BF16, True),
    (1, 28, 4, 8192, 128, BF16, BF16, True),
    (4, 28, 4, 4096, 128, BF16, BF16, True),
    (4, 14, 2, 4096, 128, BF16, BF16, True),
    (2, 28, 4, 4096, 128, BF16, torch.int8, True),
    # the new instances: Qwen2.5-0.5B (d 64, group 7), group 5 (14B/32B, and 20/4 at tp 2), group 3
    (1, 14, 2, 4096, 64, BF16, BF16, True),
    (1, 14, 2, 4096, 64, BF16, torch.int8, True),
    (1, 40, 8, 4096, 128, BF16, BF16, True),
    (1, 20, 4, 4096, 128, BF16, BF16, True),
    (1, 12, 4, 4096, 128, BF16, BF16, True),
    (1, 12, 12, 64, 64, BF16, BF16, True),  # group 1
    # refused: fp32, the selftest's head dim 16, head dim 96, a group past 8
    (1, 4, 2, 64, 16, F32, F32, False),
    (1, 4, 2, 64, 128, F32, F32, False),
    (1, 4, 2, 64, 16, BF16, BF16, False),
    (1, 8, 2, 64, 96, BF16, BF16, False),
    (1, 36, 4, 64, 128, BF16, BF16, False),
])
def test_decode_contract(b, H, KVH, S, d, q_dtype, cache_dtype, takes):
    q_shape, k_shape = (b, H, 1, d), (b, KVH, S, d)
    assert tfd.takes_decode_kernel(q_shape, k_shape, q_dtype, cache_dtype, "cuda") is takes
    assert tfd.takes_decode_kernel(q_shape, k_shape, q_dtype, cache_dtype, "cpu")


@pytest.mark.parametrize("dtypes,device,takes", [
    ((BF16,) * 3, "cuda", True),
    ((F32,) * 3, "cuda", True),  # the fp32 instance
    ((BF16, BF16, F32), "cuda", False),
    ((F32,) * 3, "cpu", True),  # the plain version takes any type
    ((torch.float16,) * 3, "cuda", False),
])
def test_tile_contract_reads_the_types_off_the_cpu(probe, dtypes, device, takes):
    """The tiling holds for the video and the image tile in bf16 and fp32
    (a 3-row segment of 1152 fp32 values is 13.8 KB of a 48 KB slot); the
    predicate counts bytes in the dtype, so a width that fits in bf16 can
    overflow in fp32. The wrapper takes bf16 or fp32 of one dtype on a device
    (meta here: its device branch) and any type on the CPU."""
    for thw, kernel in (((32, 27, 27), (4, 3, 3)), ((1, 27, 27), (1, 3, 3))):  # the video and the image tile
        assert tla.takes_tile_kernel(thw, 1152, 1152, kernel)
        assert tla.takes_tile_kernel(thw, 1152, 1152, kernel, F32)
    assert not tla.takes_tile_kernel((4, 4, 4), 64, 64, (4, 3, 3))
    assert tla.takes_tile_kernel((8, 9, 9), 6144, 64, (4, 3, 3)) and \
        not tla.takes_tile_kernel((8, 9, 9), 6144, 64, (4, 3, 3), F32)  # a 24 KB fp32 row
    dev = "meta" if device == "cuda" else device
    q, key, value = (torch.zeros(shape, dtype=dt, device=dev)
                     for shape, dt in zip(((2, 3, 3, 64), (8, 9, 9, 64), (8, 9, 9, 64)), dtypes))
    if takes:
        assert tla.fused_tile_attention(q, key, value, (4, 3, 3), 0.125).shape == (2, 3, 3, 64)
    else:
        with pytest.raises(TypeError):
            tla.fused_tile_attention(q, key, value, (4, 3, 3), 0.125)
    assert probe() == ({"K4": 1} if takes and dev == "meta" else {}, {})


# --------------------------------------------------------------------------- #
# the routes
# --------------------------------------------------------------------------- #

SDPA_CASES = {
    # name: (q shape, k shape, dtype, sdpa keywords, kernel launched or None, the wrapper's error or None)
    "so400m 729^2 d 72": ((32, 16, 729, 72), (32, 16, 729, 72), BF16, {}, "K1", None),
    "clip 577^2 d 64": ((32, 16, 577, 64), (32, 16, 577, 64), BF16, {}, "K1", None),
    "prefill 28/4": ((2, 28, 743, 128), (2, 4, 743, 128), BF16, dict(is_causal=True, lens=[743, 700]), "K2", None),
    "prefill 12/2": ((2, 12, 743, 128), (2, 2, 743, 128), BF16, dict(is_causal=True, lens=[743, 700]), "K2", None),
    "prefill 14/2 d 128": ((2, 14, 743, 128), (2, 2, 743, 128), BF16, dict(is_causal=True), "K2", None),
    "prefill 0.5b 14/2 d 64": ((2, 14, 743, 64), (2, 2, 743, 64), BF16, dict(is_causal=True, lens=[743, 700]),
                               "K2", None),
    "global 32 x 23,328": ((2, 9, 32, 128), (2, 9, 23328, 128), BF16, {}, "K2", None),
    # fp32 (flash_fwd_f32.cu), and the head dims that pad to 16 and 96, where JAX's rule picks a kernel
    "so400m fp32": ((32, 16, 729, 72), (32, 16, 729, 72), F32, {}, "K1", None),
    "prefill fp32": ((2, 28, 743, 128), (2, 4, 743, 128), F32, dict(is_causal=True), "K2", None),
    "global fp32": ((1, 9, 32, 128), (1, 9, 23328, 128), F32, {}, "K2", None),  # split, its merge inside K2
    "head dim 16": ((1, 4, 200, 16), (1, 4, 200, 16), BF16, {}, "K1", None),
    "head dim 96": ((1, 4, 200, 96), (1, 4, 200, 96), BF16, {}, "K1", None),
    "head dim 96 fp32": ((1, 4, 200, 96), (1, 4, 200, 96), F32, dict(is_causal=True), "K2", None),
    # past 128: the 192 and 256 instances (d 136 in one block, K1; d 256 grouped at the prefill, K2)
    "head dim 136": ((1, 4, 200, 136), (1, 4, 200, 136), BF16, {}, "K1", None),
    "prefill 14/2 d 256": ((2, 14, 743, 256), (2, 2, 743, 256), BF16, dict(is_causal=True, lens=[743, 700]),
                           "K2", None),
    "prefill 14/2 d 256 fp32": ((2, 14, 743, 256), (2, 2, 743, 256), F32, dict(is_causal=True), "K2", None),
    "global d 192": ((1, 9, 32, 192), (1, 9, 23328, 192), BF16, {}, "K2", None),
    # past 256: the wide kernels (d 264 in one block, K1; d 512 grouped at the prefill, K2)
    "head dim 264": ((1, 4, 200, 264), (1, 4, 200, 264), BF16, {}, "K1", None),
    "prefill 7/1 d 512": ((2, 7, 743, 512), (2, 1, 743, 512), BF16, dict(is_causal=True, lens=[743, 700]),
                          "K2", None),
    "prefill 7/1 d 512 fp32": ((2, 7, 743, 512), (2, 1, 743, 512), F32, dict(is_causal=True), "K2", None),
    # JAX's rule picks a kernel that no instance computes: the wrapper raises
    "so400m fp16": ((32, 16, 729, 72), (32, 16, 729, 72), torch.float16, {}, None, TypeError),
    "masked": ((1, 4, 200, 128), (1, 4, 200, 128), BF16, dict(mask=True), None, None),  # JAX's rule: plain
}


@pytest.mark.parametrize("name", sorted(SDPA_CASES))
def test_sdpa_routes_on_the_contract(probe, name):
    q_shape, k_shape, dtype, kw, kernel, error = SDPA_CASES[name]
    kw = dict(kw)
    lens = kw.pop("lens", None)
    if lens is not None:
        kw["kv_lengths"] = torch.tensor(lens, device="meta")
    if kw.pop("mask", False):
        kw["mask"] = torch.empty((q_shape[0], 1, q_shape[2], k_shape[2]), dtype=torch.bool, device="meta")
    q, k = meta(*q_shape, dtype=dtype), meta(*k_shape, dtype=dtype)
    with torch.inference_mode():
        if error:
            with pytest.raises(error):
                attention.sdpa(q, k, k, **kw)
        else:
            out = attention.sdpa(q, k, k, **kw)
            assert out.shape == q_shape and out.dtype == dtype
    assert probe() == ({kernel: 1} if kernel else {}, {})


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_split_key_partials_and_merge_route_on_the_contract(probe, dtype):
    """The split-key path launches K2's partials and the merge kernel in bf16
    and in fp32; the merge writes the caller's dtype."""
    q, k = meta(1, 9, 32, 128, dtype=dtype), meta(1, 9, 2916, 128, dtype=dtype)
    out = attention.sdpa(q, k, k, kv_group=attention.SoloGroup())
    assert out.shape == q.shape and out.dtype == dtype
    assert probe() == ({"K2": 1, "merge": 1}, {})


def _decoder(H, KVH, d, dtype, layers=2):
    cfg = dataclasses.replace(tcfg.tiny_test_config().text_config, num_attention_heads=H, num_key_value_heads=KVH,
                              head_dim=d, hidden_size=H * d, num_hidden_layers=layers)
    with torch.device("meta"):
        return cfg, qwen2.Qwen2Model(cfg, dtype=dtype)


@pytest.mark.parametrize("case,H,KVH,d,dtype,quantized,want", [
    # the selftest's decoder on the card (fp32, head dim 16): its grouped prefill is plain by JAX's
    # rule (d % 64 != 0), its decode by K3's contract
    ("selftest fp32 d 16", 4, 2, 16, F32, False, ({}, {"K3": 2})),
    # fp32 at head dim 128: JAX's rule sends the grouped prefill to K2 (its fp32 instance), K3's contract
    # sends the decode step to the plain path
    ("fp32 d 128", 4, 2, 128, F32, False, ({"K2": 2}, {"K3": 2})),
    ("fp32 int8 cache", 4, 2, 128, F32, True, ({"K2": 2}, {"K3": 2})),
    # bf16 at 40/8 heads (group 5), at Qwen2.5-0.5B's 14/2 heads of 64, at group 3: both kernels
    ("bf16 40/8", 40, 8, 128, BF16, False, ({"K2": 2, "K3": 2}, {})),
    ("bf16 0.5b 14/2 d 64", 14, 2, 64, BF16, False, ({"K2": 2, "K3": 2}, {})),
    ("bf16 0.5b int8 cache", 14, 2, 64, BF16, True, ({"K2": 2, "K3": 2}, {})),
    ("bf16 12/4", 12, 4, 128, BF16, False, ({"K2": 2, "K3": 2}, {})),
    ("bf16 d 96", 4, 2, 96, BF16, False, ({}, {"K3": 2})),  # grouped d 96: JAX's rule keeps the prefill plain
    # heads of 256 (HICom-7B's decoder reshaped to 14 / 2 heads of 256): the grouped prefill takes K2's 256
    # instance by JAX's d % 64 rule, the one-token step the plain route (K3 has head dims 64 and 128)
    ("bf16 14/2 d 256", 14, 2, 256, BF16, False, ({"K2": 2}, {"K3": 2})),
    ("fp32 2/1 d 256", 2, 1, 256, F32, False, ({"K2": 2}, {"K3": 2})),
])
def test_decoder_step_routes_on_the_contract(probe, case, H, KVH, d, dtype, quantized, want):
    """A prefill of 130 tokens into an empty cache, then one decode step, on
    the device branch: each call either launches (the stub) or, for K3, is
    counted on the plain route."""
    cfg, model = _decoder(H, KVH, d, dtype)
    b, L = 2, 130
    cache = qwen2.KVCache.zeros(cfg.num_hidden_layers, b, KVH, 256, d, dtype, "meta", quantized=quantized)
    pos = torch.arange(L, device="meta").expand(b, L)
    if isinstance(want, type):
        with torch.inference_mode(), pytest.raises(want):
            model(meta(b, L, cfg.hidden_size, dtype=dtype), pos, cache, prefill_from_empty=True)
        assert probe() == ({}, {})
        return
    with torch.inference_mode():
        model(meta(b, L, cfg.hidden_size, dtype=dtype), pos, cache, prefill_from_empty=True)
        out = model(meta(b, 1, cfg.hidden_size, dtype=dtype), pos[:, -1:] + 1, cache)
    assert out.shape == (b, 1, cfg.hidden_size) and cache.length == L + 1
    assert probe() == want


def test_verify_chunk_stays_plain_and_uncounted(probe):
    cfg, model = _decoder(14, 2, 64, BF16)
    cache = qwen2.KVCache.zeros(cfg.num_hidden_layers, 1, 2, 64, 64, BF16, "meta")
    with torch.inference_mode():
        model(meta(1, 4, cfg.hidden_size), torch.arange(4, device="meta")[None], cache)
    assert probe() == ({}, {})  # JAX takes XLA there too: no kernel to depart from


@pytest.mark.parametrize("dtype,want", [(BF16, ({"K4": 1}, {})), (F32, ({"K4": 1}, {})),
                                        (torch.float16, TypeError)])
def test_projector_routes_on_the_tile_contract(probe, dtype, want):
    """The local compressor takes K4 wherever the tiles fit, as JAX takes its
    Pallas kernel, in bf16 and fp32; K4 has no fp16 instance, so fp16 raises
    on a device."""
    ct = tcfg.tiny_test_config(use_guide="direct")
    with torch.device("meta"):
        local = LocalCompressor(ct.projector.local, ct.qk_dim, ct.mm_hidden_size, ct.hidden_size, "direct",
                                dtype=dtype)
    args = meta(2, 8, 9, 9, ct.mm_hidden_size, dtype=dtype), meta(2, 8, 9, 9, ct.qk_dim, dtype=dtype), \
        meta(2, ct.qk_dim, dtype=dtype)
    with torch.inference_mode():
        if isinstance(want, type):
            with pytest.raises(want):
                local(*args)
            assert probe() == ({}, {})
            return
        out = local(*args)
    assert out.shape == (2, 2, 3, 3, ct.hidden_size)
    assert probe() == want


def test_wrappers_still_raise_off_their_contract(probe):
    """The route decides before the call; the wrappers keep refusing device
    operands outside their contract: a head dim that is not a multiple of 8,
    fp16, mixed dtypes, and (before its forward runs) a forward that needs a
    gradient no K5/K6 instance computes, at such a head dim or in fp16, which
    names the instance it lacks. (fp32 and bf16 gradients at every head dim
    that is a multiple of 8 compute, past 256 too:
    ``test_gradients_reach_their_backward_instance``,
    ``test_head_dims_past_256_launch_the_wide_kernels``.)"""
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfa.flash_forward(meta(1, 4, 200, 128, dtype=torch.float16), meta(1, 4, 200, 128, dtype=torch.float16),
                          meta(1, 4, 200, 128, dtype=torch.float16), None, 0.1)
    with pytest.raises(ValueError, match="head dim 36"):
        tfa.fullblock_attention(meta(4, 200, 36), meta(4, 200, 36), meta(4, 200, 36), 0.1)
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_forward(meta(1, 4, 200, 512), meta(1, 4, 200, 512, dtype=F32), meta(1, 4, 200, 512), None, 0.1)
    for d, dtype, instance in ((36, F32, "no float32 instance at head dim 36"),
                               (36, BF16, "no bfloat16 instance at head dim 36"),
                               (96, torch.float16, "no float16 instance at head dim 96"),
                               (512, torch.float16, "no float16 instance at head dim 512")):
        q = meta(1, 4, 200, d, dtype=dtype).requires_grad_()
        with pytest.raises(TypeError, match=instance):
            tfa.flash_attention(q, q, q, is_causal=True)
    q = meta(1, 4, 200, 36, dtype=F32)
    with pytest.raises(ValueError, match="flash backward: head dim 36"):
        tfa.flash_backward(q, q, q, None, q, meta(1, 4, 200, dtype=F32), q, 0.1)
    q = meta(1, 4, 200, 128, dtype=F32)
    with pytest.raises(TypeError, match="out and dO of q's dtype"):  # one dtype throughout
        tfa.flash_backward(q, q, q, None, meta(1, 4, 200, 128), meta(1, 4, 200, dtype=F32), q, 0.1)
    with pytest.raises(TypeError, match="bfloat16"):
        tfd.flash_decode(meta(1, 4, 1, 128, dtype=F32), meta(1, 2, 64, 128), meta(1, 2, 64, 128),
                         torch.ones(1, 64, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="head dim 16 / group 2"):
        tfd.flash_decode(meta(1, 4, 1, 16), meta(1, 2, 64, 16), meta(1, 2, 64, 16),
                         torch.ones(1, 64, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="group 9"):
        tfd.flash_decode(meta(1, 18, 1, 64), meta(1, 2, 64, 64), meta(1, 2, 64, 64),
                         torch.ones(1, 64, dtype=torch.bool, device="meta"))
    with pytest.raises(TypeError):
        tla.fused_tile_attention(meta(2, 9, 9, 64, dtype=torch.float16), meta(8, 27, 27, 64, dtype=torch.float16),
                                 meta(8, 27, 27, 64, dtype=torch.float16), (4, 3, 3), 0.125)
    assert probe() == ({}, {})


@pytest.mark.parametrize("d,dtype,gqa,symbols", [
    # the cases test_wrappers_still_raise_off_their_contract held as raising before K5/K6 had them
    (128, F32, False, ("hicom_flash_bwd_dq_f32", "hicom_flash_bwd_dkv_f32")),
    (96, BF16, False, ("hicom_flash_bwd_dq", "hicom_flash_bwd_dkv")),
    # fp32 at every padded width, and the other new bf16 widths
    (16, F32, False, ("hicom_flash_bwd_dq_f32", "hicom_flash_bwd_dkv_f32")),
    (72, F32, False, ("hicom_flash_bwd_dq_f32", "hicom_flash_bwd_dkv_f32")),
    (112, F32, True, ("hicom_flash_bwd_dq_f32", "hicom_flash_bwd_dkv_f32")),
    (16, BF16, False, ("hicom_flash_bwd_dq", "hicom_flash_bwd_dkv")),
    (48, BF16, True, ("hicom_flash_bwd_dq", "hicom_flash_bwd_dkv")),
    (112, BF16, False, ("hicom_flash_bwd_dq", "hicom_flash_bwd_dkv")),
    # past 128: the 192 and 256 instances (d 136 on the 192 one)
    (256, BF16, True, ("hicom_flash_bwd_dq", "hicom_flash_bwd_dkv")),
    (192, F32, True, ("hicom_flash_bwd_dq_f32", "hicom_flash_bwd_dkv_f32")),
    (136, BF16, False, ("hicom_flash_bwd_dq", "hicom_flash_bwd_dkv")),
    (256, F32, False, ("hicom_flash_bwd_dq_f32", "hicom_flash_bwd_dkv_f32")),
    # past 256: the wide kernels of each type (the d-264 cases test_wrappers_still_raise_off_their_contract held)
    (264, F32, False, ("hicom_flash_bwd_dq_wide_f32", "hicom_flash_bwd_dkv_wide_f32")),
    (264, BF16, False, ("hicom_flash_bwd_dq_wide", "hicom_flash_bwd_dkv_wide")),
    (512, BF16, True, ("hicom_flash_bwd_dq_wide", "hicom_flash_bwd_dkv_wide")),
    (1024, F32, True, ("hicom_flash_bwd_dq_wide_f32", "hicom_flash_bwd_dkv_wide_f32")),
])
def test_gradients_reach_their_backward_instance(probe, d, dtype, gqa, symbols):
    """A gradient through ``flash_attention`` (or the GQA entry) on the device
    branch: K2 forward, then one K5/K6 launch of the instance of its dtype,
    fp32 gradients of fp32 operands; the split count comes from the shape."""
    q = meta(2, 8, 300, d, dtype=dtype).requires_grad_()
    k = meta(2, 2 if gqa else 8, 300, d, dtype=dtype).requires_grad_()
    out = (tfa.flash_attention_gqa if gqa else tfa.flash_attention)(q, k, k, is_causal=True)
    grads = torch.autograd.grad(out, (q, k), meta(*out.shape, dtype=dtype))
    assert [g.dtype for g in grads] == [dtype, dtype] and grads[1].shape == k.shape
    assert probe() == ({"K2": 1, "K5/K6": 1}, {})
    assert tuple(s for s in probe.symbols if "bwd" in s) == symbols


@pytest.mark.parametrize("dtype,symbol", [(BF16, "hicom_flash_fwd_wide"), (F32, "hicom_flash_fwd_wide_f32")])
def test_head_dims_past_256_launch_the_wide_kernels(probe, dtype, symbol):
    """The d-264 calls that raised before the wide kernels: K1 over rows of
    264 and K2 at d 264 now launch the wide forward of their dtype."""
    out, lse = tfa.fullblock_attention(meta(4, 200, 264, dtype=dtype), meta(4, 200, 264, dtype=dtype),
                                       meta(4, 200, 264, dtype=dtype), 0.1)
    assert out.shape == (4, 200, 264) and out.dtype == dtype and lse.shape == (4, 200)
    q = meta(1, 4, 200, 264, dtype=dtype)
    out, _ = tfa.flash_forward(q, q, q, None, 0.1, causal=True)
    assert out.shape == q.shape
    assert probe() == ({"K1": 1, "K2": 1}, {})
    assert [s for s in probe.symbols if "fwd" in s] == [symbol, symbol]
