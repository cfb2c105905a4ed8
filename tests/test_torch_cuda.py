"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: they skip without a CUDA device (so on the CPU test runs).
The fp32 instances (``flash_fwd_f32.cu``, ``flash_bwd_f32.cu``, K4's, the
merge's and the sum pass's fp32 forms) are held to their fp32 twins at the
fp32 gate, with the bf16 instances at head dims 16, 48, 96 and 112, and a tiny
``train.cli`` stage 2 with ``--dtype float32``; at the end of the file, the
head dims past 128 (the 192 and 256 instances, d 136 on zero columns) in both
types, forward, backward, split and merged, and a tiny HICom whose decoder has
heads of 256 on the card; then the head dims past 256 (``flash_wide.cu``,
``flash_wide_f32.cu``: d 264 to 2,048) in both types and a tiny HICom whose
decoder has heads of 512 and whose tower has a head of 288.
On a machine with a card and no JAX, run them without the JAX-loading
conftest: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

bf16 inputs. Each output element may differ from the twin's by 2^-6 |ref| +
2^-5 rms(ref), the rule of ``chip_smoke.py``: two bf16 ulps of its own value
(both sides round the output; the kernel rounds or sums p at another running
max than the twin), plus a 32nd of the output's typical size for elements near
zero, whose error is that of the row's sum of rounded terms.
"""

import math

import pytest
import torch

from hicom_tpu_torch.ops.flash_attention import (DKV_BLOCK_K, _launch, _launch_dkv, _launch_dq, _launch_merge,
                                                 _launch_part_sum, backward_operands, dkv_splits, flash_attention_gqa,
                                                 flash_backward, flash_backward_reference, flash_forward,
                                                 flash_forward_partials, flash_reference, forward_splits,
                                                 fullblock_attention, merge_partials, merge_partials_reference,
                                                 split_dkv_reference, split_dq_reference, split_forward_reference,
                                                 sum_partials_reference)
from hicom_tpu_torch.ops.flash_decode import DECODE_CHUNK, decode_reference, flash_decode
from hicom_tpu_torch.ops.local_attn import chunked_tile_reference, fused_tile_attention, tile_reference
from hicom_tpu_torch.ops.pos_embed import get_3d_sincos_pos_embed, sincos_pos_embed_3d

pytestmark = pytest.mark.cuda


@pytest.fixture
def rn():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    return lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


def _worst(got, ref):
    """The largest ratio of an element's error to its tolerance (pass: <= 1)."""
    got, ref = got.float(), ref.float()
    tol = 2**-6 * ref.abs() + 2**-5 * ref.square().mean().sqrt()
    return ((got - ref).abs() / tol).max().item()


@pytest.mark.parametrize("bh,L,d", [
    (8, 729, 72), (4, 577, 64), (3, 200, 128),
    (512, 577, 64),  # the CLIP-L/336 tower over 32 frames: 16 heads of 64, 577 tokens with CLS
    (256, 729, 72),  # so400m over the 16 crops of an anyres image
])
def test_fullblock(rn, bh, L, d):
    q, k, v = rn(bh, L, d), rn(bh, L, d), rn(bh, L, d)
    before = fullblock_attention.launches
    out, lse = fullblock_attention(q, k, v, d**-0.5, 0.1)
    ref, ref_lse = flash_reference(q[:, None], k[:, None], v[:, None], None, d**-0.5, 0.1, False)
    assert fullblock_attention.launches == before + 1
    # lse is fp32 on both sides, about log(L): 1e-3 absolute is 1e-4 of it
    assert _worst(out, ref[:, 0]) <= 1 and (lse - ref_lse[:, 0]).abs().max().item() <= 1e-3


@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens", [
    (2, 28, 4, 743, 743, 128, True, [743, 700]),
    (1, 9, 9, 32, 5000, 128, False, None),
    (2, 4, 2, 64, 192, 64, True, None),
    (2, 4, 4, 37, 130, 32, False, [100, 130]),
    (2, 9, 9, 32, 23328, 128, False, None),  # the global compressor at b 2, split over the keys
    (1, 28, 4, 7333, 7333, 128, True, [7300]),  # the prefill of an anyres image's prompt
    (1, 8, 8, 32, 18432, 128, False, None),  # the global compressor over 32 CLIP frames
])
def test_flash_forward(rn, b, H, KVH, Lq, Lk, d, causal, lens):
    q, k, v = rn(b, H, Lq, d), rn(b, KVH, Lk, d), rn(b, KVH, Lk, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, _ = flash_forward(q, k, v, kl, d**-0.5, 0.0, causal)
    ref, _ = flash_reference(q, k, v, kl, d**-0.5, 0.0, causal)
    if kl is not None:  # padded query rows are not read by anyone
        valid = (torch.arange(Lq, device="cuda")[None] < kl[:, None])[:, None, :].expand(b, H, Lq)
        out, ref = out[valid], ref[valid]
    assert _worst(out, ref) <= 1


@pytest.mark.parametrize("quantized", [False, True])
def test_flash_decode(rn, quantized):
    b, H, KVH, S, d = 2, 28, 4, 1000, 128
    q = rn(b, H, 1, d)
    mask = torch.rand(b, S, device="cuda") < 0.5
    mask[:, 0] = True
    if quantized:
        k = torch.randint(-127, 128, (b, KVH, S, d), device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, (b, KVH, S, d), device="cuda", dtype=torch.int8)
        ks, vs = torch.rand(b, KVH, S, device="cuda") * 0.02, torch.rand(b, KVH, S, device="cuda") * 0.02
    else:
        k, v, ks, vs = rn(b, KVH, S, d), rn(b, KVH, S, d), None, None
    out = flash_decode(q, k, v, mask, k_scale=ks, v_scale=vs)
    assert _worst(out, decode_reference(q, k, v, mask, ks, vs, d**-0.5)) <= 1


def test_tile_attention(rn):
    key, val, q = rn(8, 27, 27, 1152), rn(8, 27, 27, 1152), rn(2, 9, 9, 1152)
    scale = torch.tensor(1152**-0.5, device="cuda")  # a device scalar: no host sync
    out = fused_tile_attention(q, key, val, (4, 3, 3), scale, 0.0)
    assert _worst(out, tile_reference(q, key, val, (4, 3, 3), scale, 0.0)) <= 1


@pytest.mark.parametrize("thw,kernel,qk,dv", [
    ((32, 27, 27), (4, 3, 3), 1152, 1152),  # one 32-frame request
    ((64, 27, 27), (4, 3, 3), 1152, 1152),  # the batched request, b 2 folded into the frames
    ((1, 27, 27), (1, 3, 3), 1152, 1152),  # an image
    ((8, 9, 12), (4, 3, 3), 64, 200),  # qk != dv, one consumer warp for the keys, 25 chunks for the values
    ((4, 6, 8), (2, 2, 2), 1160, 8),  # a width that leaves the last warp's lanes idle
    ((32, 24, 24), (4, 3, 3), 768, 1024),  # CLIP: 768-wide projected keys, 1024-wide feature values
    ((1, 60, 108), (1, 3, 3), 1152, 1152),  # the patch grid of an anyres image under the HICom projector
])
def test_tile_kernel_main_path_shapes(rn, thw, kernel, qk, dv):
    t, h, w = thw
    kt, kh, kw = kernel
    key, val, q = rn(t, h, w, qk), rn(t, h, w, dv), rn(t // kt, h // kh, w // kw, qk)
    before = fused_tile_attention.launches
    out = fused_tile_attention(q, key, val, kernel, qk**-0.5, 0.0)
    assert fused_tile_attention.launches == before + 1
    assert _worst(out, tile_reference(q, key, val, kernel, qk**-0.5, 0.0)) <= 1
    assert _worst(out, chunked_tile_reference(q, key, val, kernel, qk**-0.5, 0.0)) <= 1


def test_tile_kernel_clip_scale_form(rn):
    # the clip-scale path: exp of a bf16 logit_scale parameter and a bf16 logit_bias, read on the card
    key, val, q = rn(8, 27, 27, 1152), rn(8, 27, 27, 1152), rn(2, 9, 9, 1152)
    logit_scale = torch.nn.Parameter(torch.tensor(-3.0, device="cuda", dtype=torch.bfloat16))
    logit_bias = torch.nn.Parameter(torch.tensor(0.4, device="cuda", dtype=torch.bfloat16))
    with torch.no_grad():
        scale = torch.exp(logit_scale)
        out = fused_tile_attention(q, key, val, (4, 3, 3), scale, logit_bias)
        assert _worst(out, tile_reference(q, key, val, (4, 3, 3), scale, logit_bias)) <= 1


def test_tile_kernel_call_does_not_sync(rn):
    # the main path's call form: Python-float scale and bias, passed by value
    key, val, q = rn(32, 27, 27, 1152), rn(32, 27, 27, 1152), rn(8, 9, 9, 1152)
    ref = fused_tile_attention(q, key, val, (4, 3, 3), 1152**-0.5, 0.0)  # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fused_tile_attention(q, key, val, (4, 3, 3), 1152**-0.5, 0.0)
        pos = sincos_pos_embed_3d(5, 7, 9, 64, q.device)  # a first call: the tables' copy does not wait
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out, ref)
    assert torch.equal(pos.cpu(), torch.from_numpy(get_3d_sincos_pos_embed(5, 7, 9, 64)))


@pytest.mark.parametrize("quantized", [False, True])
def test_flash_decode_all_clear_row(rn, quantized):
    # a row whose bitmap has no valid slot: the uniform average of its values,
    # as the TPU kernel and the twin give it
    b, H, KVH, S, d = 2, 28, 4, 1000, 128
    q = rn(b, H, 1, d)
    mask = torch.rand(b, S, device="cuda") < 0.5
    mask[0, 0], mask[1] = True, False
    if quantized:
        k = torch.randint(-127, 128, (b, KVH, S, d), device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, (b, KVH, S, d), device="cuda", dtype=torch.int8)
        ks, vs = torch.rand(b, KVH, S, device="cuda") * 0.02, torch.rand(b, KVH, S, device="cuda") * 0.02
    else:
        k, v, ks, vs = rn(b, KVH, S, d), rn(b, KVH, S, d), None, None
    out = flash_decode(q, k, v, mask, k_scale=ks, v_scale=vs)
    ref = decode_reference(q, k, v, mask, ks, vs, d**-0.5)
    assert _worst(out[1], ref[1]) <= 1 and _worst(out[0], ref[0]) <= 1


@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens,bias", [
    (2, 28, 4, 743, 743, 128, True, [743, 700], 0.0),
    (2, 9, 9, 32, 5000, 128, False, None, 0.0),
    (2, 16, 16, 729, 729, 72, False, None, 0.0),
    (2, 4, 2, 64, 192, 64, True, None, 0.3),
    (2, 4, 4, 37, 130, 32, False, [100, 130], -0.2),
])
def test_flash_backward(rn, b, H, KVH, Lq, Lk, d, causal, lens, bias):
    q, k, v, do = rn(b, H, Lq, d), rn(b, KVH, Lk, d), rn(b, KVH, Lk, d), rn(b, H, Lq, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = flash_forward(q, k, v, kl, d**-0.5, bias, causal)
    before = flash_backward.launches
    got = flash_backward(q, k, v, kl, out, lse, do, d**-0.5, bias, causal)
    assert flash_backward.launches == before + 1
    ref = flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, bias, causal)
    assert max(_worst(g, r) for g, r in zip(got, ref)) <= 1


def test_flash_function_backward_runs_the_kernels(rn):
    b, H, KVH, L, d = 2, 8, 2, 150, 128
    q, k, v, do = rn(b, H, L, d), rn(b, KVH, L, d), rn(b, KVH, L, d), rn(b, H, L, d)
    kl = torch.tensor([150, 120], device="cuda", dtype=torch.int32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (flash_forward.launches, flash_backward.launches)
    out = flash_attention_gqa(*leaves, is_causal=True, kv_lengths=kl)
    grads = torch.autograd.grad(out, leaves, do)
    assert (flash_forward.launches, flash_backward.launches) == (before[0] + 1, before[1] + 1)
    _, lse = flash_reference(q, k, v, kl, d**-0.5, 0.0, True)
    ref = flash_backward_reference(q, k, v, kl, out.detach(), lse.float(), do, d**-0.5, 0.0, True)
    assert max(_worst(g, r) for g, r in zip(grads, ref)) <= 1
    with torch.inference_mode():  # serving: the forward kernel alone, nothing saved
        assert not flash_attention_gqa(q, k, v, is_causal=True, kv_lengths=kl).requires_grad


def test_tile_kernel_refuses_gradients(rn):
    key, val, q = rn(8, 27, 27, 64), rn(8, 27, 27, 64), rn(2, 9, 9, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_tile_attention(q, key, val, (4, 3, 3), 0.125, 0.0)


def test_cuda_wrappers_refuse_what_they_cannot_take(rn):
    q = rn(2, 4, 16, 72).half()  # fp16: the kernels take bf16 and fp32
    with pytest.raises(TypeError):
        flash_forward(q, q, q, None, 0.1, 0.0, False)
    q = rn(2, 4, 16, 36)  # a head dim that is not a multiple of 8 (past 256 the wide kernels compute)
    with pytest.raises(ValueError, match="head dim 36"):
        flash_forward(q, q, q, None, 0.1, 0.0, False)
    q = rn(2, 4, 200, 36).float().requires_grad_()  # a forward that needs a gradient no K5/K6 instance computes
    before = flash_forward.launches
    with pytest.raises(TypeError, match="K5/K6 have no float32 instance at head dim 36"):
        flash_attention_gqa(q, q, q, is_causal=True)
    assert flash_forward.launches == before
    q = rn(2, 4, 16, 264)  # the d-264 call that raised here before the wide kernels: it launches now
    out, _ = flash_forward(q, q, q, None, 0.1, 0.0, False)
    assert flash_forward.launches == before + 1
    assert _worst(out, flash_reference(q, q, q, None, 0.1, 0.0, False)[0]) <= 1


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens", [
    (2, 4, 4, 37, 130, 32, False, [100, 130]),  # 3 and 7 chunks: some walk nothing (past kv_lengths)
    (2, 4, 2, 300, 300, 64, True, [217, 300]),  # chunks all masked for some rows (above their diagonal)
    (1, 3, 3, 200, 729, 72, False, None),  # d 72 (K1's width), ragged last tile
])
def test_flash_forward_forced_split(rn, b, H, KVH, Lq, Lk, d, causal, lens, n_split):
    q, k, v = rn(b, H, Lq, d), rn(b, KVH, Lk, d), rn(b, KVH, Lk, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = _launch(q, k, v, kl, d**-0.5, 0.1, causal, n_split=n_split)
    ref, ref_lse = flash_reference(q, k, v, kl, d**-0.5, 0.1, causal)
    assert _worst(out, ref) <= 1 and (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("causal,lens", [(True, None), (False, [0, 60])])
def test_flash_forward_rows_without_keys(rn, causal, lens, n_split):
    # rows with no valid key (causal with Lq > Lk; a zero kv length) give the twin's mean of all values
    q, k, v = rn(2, 2, 100, 32), rn(2, 2, 60, 32), rn(2, 2, 60, 32)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, _ = _launch(q, k, v, kl, 0.2, 0.0, causal, n_split=n_split)
    assert _worst(out, flash_reference(q, k, v, kl, 0.2, 0.0, causal)[0]) <= 1


def test_global_shape_splits_fill_the_card():
    assert 2 * 9 * forward_splits(2, 9, 32, 23328, d=128) >= 132 and 9 * forward_splits(1, 9, 32, 23328, d=128) >= 132


@pytest.mark.parametrize("n_split", [1, 2, 5, 14])
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens", [
    (2, 9, 9, 32, 5000, 128, False, None),  # the global compressor's 32-row tiles
    (2, 4, 2, 300, 300, 64, True, [217, 300]),
    (2, 4, 4, 37, 130, 80, False, [100, 130]),
])
def test_dq_forced_split(rn, b, H, KVH, Lq, Lk, d, causal, lens, n_split):
    q, k, v, do = rn(b, H, Lq, d), rn(b, KVH, Lk, d), rn(b, KVH, Lk, d), rn(b, H, Lq, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = flash_forward(q, k, v, kl, d**-0.5, 0.0, causal)
    ops = backward_operands(q, k, v, kl, out, lse, do)
    dq = _launch_dq(*ops, d**-0.5, 0.0, causal, n_split=n_split)
    assert _worst(dq, flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, 0.0, causal)[0]) <= 1


def test_merge_and_sum_kernels_match_their_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(1)
    n, rows, d = 5, 300, 72
    o = torch.randn(n, rows, d, generator=gen, device="cuda")
    m = torch.randn(n, rows, generator=gen, device="cuda") * 3
    m[1] = -1e30  # a chunk all masked for every row
    m[2, :100] = float("-inf")  # chunks that walked no tile
    m[:, 200:] = -1e30  # rows whose chunks are all masked
    l = torch.rand(n, rows, generator=gen, device="cuda") * 10 + 1
    out, lse = _launch_merge(o, m, l)
    ref, ref_lse = merge_partials_reference(o, m, l, torch.bfloat16)
    assert _worst(out, ref) <= 1 and (lse - ref_lse).abs().max().item() <= 1e-3
    dq, = _launch_part_sum((o, 0.125))
    assert _worst(dq, sum_partials_reference(o, 0.125, torch.bfloat16)) <= 1


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens", [
    (1, 28, 4, 256, 256, 128, True, None),  # a ring block on the diagonal
    (2, 9, 9, 32, 700, 128, False, [0, 500]),  # a rank's global-compressor chunk, one row with no valid key
])
def test_forward_partials_merge_to_the_forward(rn, b, H, KVH, Lq, Lk, d, causal, lens, n_split):
    """K2's fp32 partials alone (no merge), merged by the merge wrapper, equal
    the plain forward; a row with no valid key is the mean of the values."""
    q, k, v = rn(b, H, Lq, d), rn(b, KVH, Lk, d), rn(b, KVH, Lk, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    parts = _launch(q, k, v, kl, d**-0.5, 0.1, causal, n_split=n_split, partials=True)
    assert parts[0].shape == (n_split, b, H, Lq, d) and parts[0].dtype == torch.float32
    out, lse = merge_partials(*parts, torch.bfloat16)
    ref, ref_lse = flash_reference(q, k, v, kl, d**-0.5, 0.1, causal)
    assert _worst(out, ref) <= 1
    ok = ref_lse > -1e29
    assert (lse[ok] - ref_lse[ok]).abs().max().item() <= 1e-3
    o, m, l = flash_forward_partials(q, k, v, kl, d**-0.5, 0.1, causal)
    assert _worst(merge_partials(o, m, l, torch.bfloat16)[0], ref) <= 1


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens,bias", [
    (2, 28, 4, 743, 743, 128, True, [743, 700], 0.0),  # the decoder prefill (dkv_splits picks 2)
    (2, 6, 2, 130, 130, 64, True, [90, 130], 0.3),  # GQA, a key tile wholly past kv_lengths
    (1, 3, 3, 200, 729, 72, False, None, 0.0),  # d 72 (the tower's width), ragged tiles, G = 1
    (2, 4, 4, 37, 130, 32, False, [100, 130], -0.2),  # one query tile: 3 and 7 splits leave empty ranges
])
def test_dkv_forced_split(rn, b, H, KVH, Lq, Lk, d, causal, lens, bias, n_split):
    q, k, v, do = rn(b, H, Lq, d), rn(b, KVH, Lk, d), rn(b, KVH, Lk, d), rn(b, H, Lq, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = flash_forward(q, k, v, kl, d**-0.5, bias, causal)
    ops = backward_operands(q, k, v, kl, out, lse, do)
    dk, dv = _launch_dkv(*ops, d**-0.5, bias, causal, n_split=n_split)
    _, ref_dk, ref_dv = flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, bias, causal)
    assert _worst(dk, ref_dk) <= 1 and _worst(dv, ref_dv) <= 1


def test_dkv_sum_kernel_matches_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(2)
    dk_part, dv_part = (torch.randn(3, 2, 4, 100, 72, generator=gen, device="cuda") for _ in range(2))
    dk, dv = _launch_part_sum((dk_part, 0.125), (dv_part, 1.0))
    assert _worst(dk, sum_partials_reference(dk_part, 0.125, torch.bfloat16)) <= 1
    assert _worst(dv, sum_partials_reference(dv_part, 1.0, torch.bfloat16)) <= 1


def test_decoder_dkv_grid_fills_the_card():
    assert -(-743 // DKV_BLOCK_K) * 2 * 4 * dkv_splits(2, 28, 4, 743, 743, d=128) >= 132


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("g", [1, 7, 8])
@pytest.mark.parametrize("b", [1, 2])
def test_flash_decode_chunks(rn, b, g, quantized):
    """Valid slots ending inside a chunk, empty chunks after them, a last chunk
    past S (1000 slots), and at b 2 a row whose bitmap is all clear; each row
    held to the twin on its own."""
    KVH, S, d = 4, 1000, 128
    q = rn(b, KVH * g, 1, d)
    slot = torch.arange(S, device="cuda")
    mask = torch.stack([slot < 3 * DECODE_CHUNK + 11, torch.zeros_like(slot, dtype=torch.bool)])[:b]
    if quantized:
        k = torch.randint(-127, 128, (b, KVH, S, d), device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, (b, KVH, S, d), device="cuda", dtype=torch.int8)
        ks, vs = torch.rand(b, KVH, S, device="cuda") * 0.02, torch.rand(b, KVH, S, device="cuda") * 0.02
    else:
        k, v, ks, vs = rn(b, KVH, S, d), rn(b, KVH, S, d), None, None
    before = flash_decode.launches
    out = flash_decode(q, k, v, mask, k_scale=ks, v_scale=vs)
    assert flash_decode.launches == before + 1
    ref = decode_reference(q, k, v, mask, ks, vs, d**-0.5)
    assert max(_worst(out[r], ref[r]) for r in range(b)) <= 1


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("d", [64, 128])
def test_flash_decode_every_width(rn, d, g, quantized):
    """Every instance of K3 (head dim 64 or 128, groups 1-8, bf16 or int8
    cache): valid slots ending inside a chunk, and a row with no valid slot,
    each row held to the twin on its own."""
    b, KVH, S = 2, 2, 1000
    q = rn(b, KVH * g, 1, d)
    slot = torch.arange(S, device="cuda")
    mask = torch.stack([slot < 5 * DECODE_CHUNK + 7, torch.zeros_like(slot, dtype=torch.bool)])
    if quantized:
        k = torch.randint(-127, 128, (b, KVH, S, d), device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, (b, KVH, S, d), device="cuda", dtype=torch.int8)
        ks, vs = torch.rand(b, KVH, S, device="cuda") * 0.02, torch.rand(b, KVH, S, device="cuda") * 0.02
    else:
        k, v, ks, vs = rn(b, KVH, S, d), rn(b, KVH, S, d), None, None
    before = flash_decode.launches
    out = flash_decode(q, k, v, mask, k_scale=ks, v_scale=vs)
    assert flash_decode.launches == before + 1
    ref = decode_reference(q, k, v, mask, ks, vs, d**-0.5)
    assert max(_worst(out[r], ref[r]) for r in range(b)) <= 1


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("H,KVH,d,fill", [
    (14, 2, 64, 233),  # Qwen2.5-0.5B at [baseline-0.5b]'s fill
    (40, 8, 128, 760),  # group 5: Qwen2.5-14B/32B
    (20, 4, 128, 760),  # group 5 at tp 2
    (12, 4, 128, 760),  # group 3
])
def test_flash_decode_new_widths_at_serving_shapes(rn, H, KVH, d, fill, quantized):
    S = 4096
    q = rn(1, H, 1, d)
    mask = (torch.arange(S, device="cuda") < fill)[None]
    if quantized:
        k = torch.randint(-127, 128, (1, KVH, S, d), device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, (1, KVH, S, d), device="cuda", dtype=torch.int8)
        ks, vs = torch.rand(1, KVH, S, device="cuda") * 0.02, torch.rand(1, KVH, S, device="cuda") * 0.02
    else:
        k, v, ks, vs = rn(1, KVH, S, d), rn(1, KVH, S, d), None, None
    out = flash_decode(q, k, v, mask, k_scale=ks, v_scale=vs)
    assert _worst(out, decode_reference(q, k, v, mask, ks, vs, d**-0.5)) <= 1


def test_selftest_runs_on_the_card_in_fp32(tmp_path):
    """``python -m hicom_tpu_torch.selftest``'s loop at its defaults (fp32, a
    decoder of head dim 16) on the card: its decode steps, which K3's
    contract refuses, take the plain masked attention (JAX's default decode),
    and the loop ends with a score."""
    from hicom_tpu_torch import selftest
    from hicom_tpu_torch.ops.cuda_build import plain_route

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plain_route.reset()
    out = selftest.run(str(tmp_path))
    assert 0.0 <= out["videomme_accuracy"] <= 100.0 and out["n_questions"] > 0
    assert plain_route.counts["K3"] > 0
    plain_route.reset()


def test_fp32_model_init_gives_the_cpus_string_on_the_card(tmp_path):
    """An fp32 export at the tiny widths (text head dim 32; a 56 x 56 tower,
    whose 4 x 4 patch grid the 3 x 3 tiles do not divide and whose 16 tokens
    JAX's rule keeps off the flash kernels) through ``model_init`` +
    ``mm_infer`` on the card and on the CPU: the same string, no kernel
    launched on the card, the decode steps refused by K3's contract and
    counted on the plain route."""
    import dataclasses
    import json

    import numpy as np

    from hicom_tpu_torch import api, tiny_test_config
    from hicom_tpu_torch.ops.cuda_build import plain_route
    from hicom_tpu_torch.selftest import WORDS, _write_wordlevel_tokenizer
    from hicom_tpu_torch.weights import export_hf_checkpoint

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tower, ckpt = tmp_path / "siglip-56", tmp_path / "hicom-fp32"
    tower.mkdir()
    cfg = tiny_test_config(dtype="float32", use_guide=None, mm_vision_tower=str(tower))
    cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, vocab_size=3 + len(WORDS), eos_token_id=2))
    with open(tower / "config.json", "w") as f:
        json.dump({"model_type": "siglip", "vision_config": dataclasses.asdict(cfg.vision_config),
                   "text_config": dataclasses.asdict(cfg.guide_text_config)}, f)
    export_hf_checkpoint(api.build_model(cfg, device="cpu", seed=3, std=0.2).state_dict(), cfg, str(ckpt))
    _write_wordlevel_tokenizer(str(ckpt), WORDS)
    pixels = np.random.default_rng(4).uniform(-1, 1, (4, 3, 56, 56)).astype(np.float32)
    wrappers = (fullblock_attention, flash_forward, flash_decode, fused_tile_attention)
    strings = {}
    for device in ("cuda", "cpu"):
        hc, _, tok = api.model_init(str(ckpt), dtype="float32", device=device)
        before = [f.launches for f in wrappers]
        plain_route.reset()
        strings[device] = api.mm_infer(pixels, "what is in the video ?", hc, tok, max_new_tokens=6)
        if device == "cuda":
            assert [f.launches for f in wrappers] == before
            assert plain_route.counts["K3"] > 0
    plain_route.reset()
    assert strings["cuda"] == strings["cpu"]


def _small_decoder_model(rn):
    """A small HICom model on the card whose decoder takes K2/K5/K6 (head_dim
    64, GQA 4/2, causal, 150 prompt tokens with a right-padded row), and a
    seeded batch for it."""
    import dataclasses

    import numpy as np

    from hicom_tpu_torch import config as tcfg
    from hicom_tpu_torch.api import build_model
    from hicom_tpu_torch.train.train_step import batch_to_device

    cfg = tcfg.tiny_test_config(dtype="bfloat16")
    cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, hidden_size=256, head_dim=64,
                                                      num_attention_heads=4, num_key_value_heads=2))
    rng = np.random.default_rng(0)
    ids = rng.integers(3, cfg.text_config.vocab_size, (2, 150))
    ids[:, 2] = -201
    mask = np.ones((2, 150), bool)
    mask[1, 120:] = False
    labels = np.where(mask, ids, -100)
    labels[:, :4] = -100
    frames = rng.standard_normal((2, 4, 3, 56, 56)).astype(np.float32)
    batch = batch_to_device(dict(input_ids=ids, attention_mask=mask, labels=labels, frames=frames),
                            torch.device("cuda"), torch.bfloat16)
    return cfg, build_model(cfg, device="cuda", seed=0), batch


def test_remat_gradients_bit_equal_through_the_kernels(rn):
    # the recompute must repeat the forward kernels exactly: K2's split grid
    # and merge order do not depend on anything but the shapes
    import dataclasses

    from hicom_tpu_torch.train.optimizer import build_optimizer
    from hicom_tpu_torch.train.train_step import make_loss_fn

    cfg, model, batch = _small_decoder_model(rn)
    build_optimizer(model, learning_rate=1e-3, tunable_parts="mm_projector,language_model").init(model)
    decoder = model.model

    def grads(remat):
        decoder.config = dataclasses.replace(decoder.config, remat=remat)
        for p in model.parameters():
            p.grad = None
        before = (flash_forward.launches, flash_backward.launches)
        loss, _ = make_loss_fn(model)(batch)
        loss.backward()
        launched = (flash_forward.launches - before[0], flash_backward.launches - before[1])
        return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}, launched

    loss0, g0, n0 = grads(False)
    loss1, g1, n1 = grads(True)
    layers = cfg.text_config.num_hidden_layers
    assert n0 == (layers, layers) and n1 == (2 * layers, layers)  # remat runs each layer's forward again
    assert torch.equal(loss0, loss1) and set(g0) == set(g1) and g0
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_lora_step_matches_the_plain_route(rn, monkeypatch):
    from hicom_tpu_torch.ops import attention
    from hicom_tpu_torch.train.lora import init_lora_params
    from hicom_tpu_torch.train.train_step import create_lora_state, make_lora_train_step

    cfg, model, batch = _small_decoder_model(rn)
    lora = init_lora_params(model, rank=8, generator=torch.Generator("cuda").manual_seed(1))
    gen = torch.Generator("cuda").manual_seed(2)
    for ab in lora.values():  # B nonzero, so the adapters act on the forward too
        ab["b"] = torch.randn(ab["b"].shape, generator=gen, device="cuda") * 0.02
    base = {n: p.detach().clone() for n, p in model.named_parameters()}

    def step():
        for n, p in model.named_parameters():
            p.data.copy_(base[n])
        state = create_lora_state(model, lora, alpha=16.0, rank=8, learning_rate=1e-3, total_steps=10)
        before = flash_backward.launches
        state, metrics = make_lora_train_step()(state, batch)
        state.lora.detach()
        grads = {n: p.grad.float() for n, p in state.lora.named_parameters()}
        return float(metrics["loss"]), grads, flash_backward.launches - before, state.lora.adapters()

    loss_k, got, launched, moved = step()
    monkeypatch.setattr(attention, "flash_route", lambda *a, **k: None)
    loss_p, ref, launched_plain, _ = step()
    assert launched == cfg.text_config.num_hidden_layers and launched_plain == 0
    assert all(torch.equal(p, base[n]) for n, p in model.named_parameters())  # the base stays frozen
    assert all(not torch.equal(moved[n]["b"], lora[n]["b"]) for n in lora)
    # bf16 activations round at other points on the two routes (flash tiles
    # against a whole-row fp32 softmax) through 2 tower, 2 guide and 2 decoder
    # layers: chip_smoke.py's rule, 5% of the gradients' global norm
    diff = sum((got[n] - ref[n]).square().sum() for n in ref).sqrt()
    norm = sum(r.square().sum() for r in ref.values()).sqrt()
    assert abs(loss_k - loss_p) <= 0.02 * abs(loss_p) and float(diff) <= 0.05 * float(norm) and float(norm) > 0


def test_safetensors_round_trip_on_the_card(rn, tmp_path):
    from hicom_tpu_torch.weights import load_safetensors, save_safetensors

    want = {"w": rn(64, 72), "scale": rn(3).float(), "ids": torch.arange(7, device="cuda"),
            "mask": torch.ones(5, device="cuda", dtype=torch.bool)}
    save_safetensors(want, str(tmp_path / "m.safetensors"))
    got = load_safetensors(str(tmp_path / "m.safetensors"), device="cuda")
    assert set(got) == set(want)
    assert all(got[k].is_cuda and got[k].dtype == v.dtype and torch.equal(got[k], v) for k, v in want.items())


@pytest.mark.parametrize("rows", [1, 2, 17, 23328])
def test_int8_matmul_on_the_card_is_exact(rows):
    """``_int_mm`` (rows below 17 padded with zero codes) against the exact
    product of the same codes on the CPU, at the tower MLP's K 1152 -> N 4304."""
    from hicom_tpu_torch.models.quant import int8_matmul

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 1152), generator=gen, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (4304, 1152), generator=gen, device="cuda", dtype=torch.int8)
    got = int8_matmul(a, w)
    assert got.dtype == torch.int32 and got.shape == (rows, 4304)
    assert torch.equal(got.cpu(), int8_matmul(a.cpu(), w.cpu()))


def test_qlora_base_saves_codes_not_weights(rn):
    """An NF4 linear under autograd keeps its packed codes and scales for the
    backward (a few bytes a weight), never a dequantized bf16 copy."""
    from hicom_tpu_torch.models.quant import QuantLinear4

    lin = QuantLinear4(3584, 18944, False, torch.bfloat16).cuda()
    lin.set_weight(rn(18944, 3584))
    x = rn(2, 64, 3584).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = lin(x)
    y.float().sum().backward()
    big = [t for t in saved if t.numel() >= 18944 * 3584 // 2]
    assert big and all(t.dtype == torch.uint8 for t in big), [(t.dtype, tuple(t.shape)) for t in saved]
    assert sum(t.numel() * t.element_size() for t in saved) < 18944 * 3584  # < 1 byte a weight
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()


def test_device_preprocess_exact_under_tf32_and_without_sync():
    """The preprocess on the card with TF32 allowed: the CPU's pixels, up to
    one uint8 level on at most 0.1% of them; a second call (tables cached)
    makes no call that waits for the device."""
    import numpy as np

    from hicom_tpu_torch.ops.preprocess import DeviceSiglipPreprocessor

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = np.random.default_rng(0).integers(0, 256, (8, 360, 640, 3), dtype=np.uint8)
    ref = DeviceSiglipPreprocessor(device="cpu")(frames)["pixel_values"]
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        proc = DeviceSiglipPreprocessor(device="cuda")
        proc(frames)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = proc(frames)["pixel_values"]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    diff = (got.cpu() - ref).abs()
    assert diff.max().item() <= 2 / 255 * 1.001 and (diff > 1e-6).float().mean().item() <= 1e-3


def test_mm_infer_takes_a_device_tensor_as_it_is(monkeypatch):
    """Pixels already on the card reach the model without a trip through numpy."""
    import numpy as np

    from hicom_tpu_torch import api, tiny_test_config

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    cfg = tiny_test_config(dtype="bfloat16")  # K3 takes bf16 and head_dim 128
    cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, head_dim=128))
    hc = api.HICom(config=cfg, model=api.build_model(cfg, device="cuda"), eos_token_id=2, cache_len=256)
    pix = torch.randn(4, 3, 56, 56, device="cuda", dtype=torch.bfloat16)
    real = np.asarray

    def no_tensors(x, *a, **k):
        assert not isinstance(x, torch.Tensor), "a device tensor went through numpy"
        return real(x, *a, **k)

    monkeypatch.setattr(api.np, "asarray", no_tensors)
    assert hc._to_dev(pix, torch.bfloat16) is pix
    ids = hc.generate(np.array([[5, 6, -201, 7, 8]]), frames=pix[None], max_new_tokens=3)
    assert ids.shape == (1, 3)


def _engine_model():
    """A 2-layer bf16 HICom model whose decoder steps take K3 (head_dim 128,
    GQA 4/2), weights N(0, 0.2) from a seed, and 4 requests for it."""
    import dataclasses

    import numpy as np

    from hicom_tpu_torch import api, tiny_test_config
    from hicom_tpu_torch.serve import GenRequest

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tiny_test_config(dtype="bfloat16")
    cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, head_dim=128))
    model = api.build_model(cfg, device="cuda", seed=0, std=0.2)
    rng = np.random.default_rng(1)
    reqs = []
    for i, (L, budget) in enumerate(((10, 20), (7, 9), (14, 30), (5, 12))):
        ids = rng.integers(5, cfg.text_config.vocab_size, (L,))
        frames = None
        if i % 2 == 0:
            ids[3] = -201
            frames = rng.standard_normal((4, 3, 56, 56)).astype(np.float32)
        reqs.append(GenRequest(input_ids=ids, frames=frames, modal="video" if frames is not None else "text",
                               max_new_tokens=budget))
    return model, reqs


@pytest.mark.parametrize("spec_k", [0, 3])
def test_graphed_rounds_equal_eager_ones(spec_k):
    """The engine's rounds captured as CUDA graphs and replayed give the eager
    rounds' streams bit for bit (2 slots, so slots refill; with spec_k the
    plain_hist and spec kinds both run), and K3 launches inside each captured
    plain round, one per layer and step."""
    from hicom_tpu_torch.serve import ServeEngine

    model, reqs = _engine_model()

    def run(graphs):
        eng = ServeEngine(model, n_slots=2, cache_len=512, prompt_buckets=(16,), sync_steps=4, eos_token_id=2,
                          spec_k=spec_k, spec_max_active=2, spec_min_accept=0.0, cuda_graphs=graphs)
        ids = [eng.submit(r) for r in reqs]
        res = eng.run()
        return [res[i].tokens.tolist() for i in ids], eng

    eager, _ = run(False)
    graphed, eng = run(True)
    assert graphed == eager
    assert sum(eng.replays.values()) > 0
    plain = "plain_hist" if spec_k else "plain"
    if plain in eng.graph_launches:
        assert eng.graph_launches[plain] == 2 * 4
    assert eng.graph_launches.get("spec", 0) == 0  # a verify chunk takes the plain masked path


@pytest.mark.parametrize("spec_k", [0, 3])
def test_mesh_engine_graphs_capture_its_collectives(spec_k, monkeypatch):
    """``ServeEngine(mesh=)`` at tp 1 in a one-rank NCCL group: the tp
    collectives (two all-reduces a layer and step, one gather of the logits)
    are issued and captured inside the round graphs, and the graphed rounds
    give the eager rounds' streams and those of the engine without a mesh,
    bit for bit."""
    import socket

    import torch.distributed as dist

    from hicom_tpu_torch.parallel.mesh import create_mesh, init_distributed
    from hicom_tpu_torch.serve import ServeEngine

    model, reqs = _engine_model()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    init_distributed("cuda")
    try:
        mesh = create_mesh(1, 1, 1)

        def run(graphs, mesh):
            eng = ServeEngine(model, n_slots=2, cache_len=512, prompt_buckets=(16,), sync_steps=4, eos_token_id=2,
                              spec_k=spec_k, spec_max_active=2, spec_min_accept=0.0, cuda_graphs=graphs, mesh=mesh)
            ids = [eng.submit(r) for r in reqs]
            res = eng.run()
            return [res[i].tokens.tolist() for i in ids], eng

        eager, _ = run(False, mesh)
        graphed, eng = run(True, mesh)
        plain, _ = run(True, None)
    finally:
        dist.destroy_process_group()
    assert graphed == eager == plain
    assert sum(eng.replays.values()) > 0
    layers = model.hicom_config.text_config.num_hidden_layers
    for kind, n in eng.graph_collectives.items():  # per step: 2 sums a layer, 1 gather (spec: the same, k+1 wide)
        assert n == 4 * (2 * layers + 1), (kind, n)


def test_sample_token_is_multinomial_on_the_card():
    """``sample_token`` draws ``torch.multinomial``'s sample (the same tokens
    from the same generator state), and a batch's rows drawn apart take the
    whole batch's noise."""
    from hicom_tpu_torch.models.generate import sample_token

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    logits = torch.randn(6, 152064, generator=torch.Generator("cuda").manual_seed(2), device="cuda")
    g1, g2 = torch.Generator("cuda").manual_seed(5), torch.Generator("cuda").manual_seed(5)
    got = sample_token(logits, g1, 1.0, 1.0)
    assert torch.equal(got, torch.multinomial(torch.softmax(logits, -1), 1, generator=g2)[:, 0])
    for rows in (slice(0, 3), slice(3, 6)):
        part = sample_token(logits[rows], torch.Generator("cuda").manual_seed(5), 1.0, 1.0, (rows, 6))
        assert torch.equal(part, got[rows])


def test_per_slot_step_hides_stale_candidates_on_the_card(rn, monkeypatch):
    """A per-slot one-token step over rows at other offsets with pad holes and
    stale valid slots past the offset: K3 takes valid & (slot <= offset), its
    output equals the plain twin's on that mask, the layer's attention equals
    the plain route's, and the stale slots would have changed the answer."""
    from hicom_tpu_torch.models import qwen2
    from hicom_tpu_torch.models.qwen2 import KVCache, rotary_tables

    model, _ = _engine_model()
    tc = model.hicom_config.text_config
    b, S, KVH, d = 3, 512, tc.num_key_value_heads, tc.head_dim
    slot = torch.arange(S, device="cuda")
    lengths = torch.tensor([40, 200, 333], device="cuda")
    valid = slot[None, :] < lengths[:, None]
    valid[1, 60:90] = False  # a right-padded prompt's pad slots
    valid[2, 333:337] = True  # an unaccepted speculative chunk past the offset

    def cache():
        gen = torch.Generator("cuda").manual_seed(3)
        kv = [torch.randn(tc.num_hidden_layers, b, KVH, S, d, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2)]
        return KVCache(kv[0], kv[1], valid.clone(), 0, lengths=lengths.clone())

    x = rn(b, 1, tc.hidden_size)
    pos = (lengths - 3)[:, None]
    rope = rotary_tables(pos, d, tc.rope_theta, torch.bfloat16)
    attn = model.model.layers[0].self_attn
    offsets = lengths[:, None]
    outs, masks = [], []
    for route in ("kernel", "plain"):
        c = cache()
        c.valid.scatter_(1, offsets, True)
        mask = c.valid & (slot[None, :] <= offsets)
        if route == "plain":
            monkeypatch.setattr(qwen2, "flash_decode", lambda q, k, v, m, k_scale=None, v_scale=None, scale=None:
                                decode_reference(q, k, v, m, k_scale, v_scale, scale))
        before = flash_decode.launches
        with torch.inference_mode():
            outs.append(attn(x, rope, c, 0, None, False, mask, offsets))
        assert flash_decode.launches == before + (route == "kernel")
        masks.append((c, mask))
    assert _worst(outs[0], outs[1]) <= 1
    c, mask = masks[0]
    q = rn(b, tc.num_attention_heads, 1, d)
    got = flash_decode(q, c.k[0], c.v[0], mask)
    assert _worst(got, decode_reference(q, c.k[0], c.v[0], mask, None, None, d**-0.5)) <= 1
    stale = decode_reference(q, c.k[0], c.v[0], c.valid, None, None, d**-0.5)
    assert (stale[2] - got[2]).abs().max().item() > 1e-2 and _worst(stale[:2], got[:2]) <= 1


def test_device_time_times_a_k2_call_with_cuda_events(rn):
    """``profiling.device_time`` on the card: each call of the chain launches
    K2 once (the warm-up chain too), the output feeds the next call's query,
    and the time comes from CUDA events."""
    from hicom_tpu_torch.profiling import device_time

    q, k, v = rn(1, 28, 512, 128), rn(1, 4, 512, 128), rn(1, 4, 512, 128)
    before = flash_forward.launches
    t = device_time(flash_forward, q, k, v, None, 128**-0.5, 0.0, True, iters=3, chain=2,
                    feedback=lambda out, a: (out[0],) + a[1:])
    assert flash_forward.launches - before == (3 + 1) * 2
    assert 0 < t < 0.05


def test_eval_runner_on_the_card_writes_the_cpus_answers(tmp_path, monkeypatch):
    """The port's eval runner on a tiny bf16 export (text head_dim 128: at the
    tiny config's 32 K3's contract refuses the decode steps and JAX's rule
    keeps the grouped prefill plain, so no kernel would launch; weights
    N(0, 0.2)) writes the same mini Video-MME
    answer files with ``--device cuda`` as with ``--device cpu``, from the
    same generated strings, and launches the kernels on the card."""
    import dataclasses
    import json

    from hicom_tpu_torch import api, tiny_test_config
    from hicom_tpu_torch.eval import runner
    from hicom_tpu_torch.selftest import WORDS, _write_wordlevel_tokenizer, build_mini_videomme
    from hicom_tpu_torch.weights import export_hf_checkpoint

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tower, ckpt = tmp_path / "siglip-so400m-patch14-384", tmp_path / "HICom_tiny_sft"
    tower.mkdir()
    cfg = tiny_test_config(dtype="bfloat16")
    cfg = cfg.replace(text_config=dataclasses.replace(cfg.text_config, head_dim=128, vocab_size=3 + len(WORDS),
                                                      eos_token_id=2),
                      mm_vision_tower=str(tower), use_guide=None, num_frames=4)
    with open(tower / "config.json", "w") as f:
        json.dump({"model_type": "siglip", "vision_config": dataclasses.asdict(cfg.vision_config),
                   "text_config": dataclasses.asdict(cfg.guide_text_config)}, f)
    model = api.build_model(cfg, device="cuda", seed=3, std=0.2)
    export_hf_checkpoint(model.state_dict(), cfg, str(ckpt))
    del model
    _write_wordlevel_tokenizer(str(ckpt), WORDS)
    qf, vids, subs = build_mini_videomme(str(tmp_path))
    answers, launches, strings = {}, {}, []
    mm_infer = runner.mm_infer
    monkeypatch.setattr(runner, "mm_infer", lambda *a, **k: strings.append(mm_infer(*a, **k)) or strings[-1])
    for device in ("cuda", "cpu"):
        path = tmp_path / device / "preds.json"
        before = flash_decode.launches, flash_forward.launches
        runner.main(["--benchmark", "videomme", "--model-path", str(ckpt), "--question-file", qf, "--video-folder",
                     vids, "--subtitle-folder", subs, "--answer-file", str(path), "--max-new-tokens", "4",
                     "--device", device])
        launches[device] = (flash_decode.launches - before[0], flash_forward.launches - before[1])
        answers[device] = path.read_text() + (tmp_path / device / "preds_sub.json").read_text()
    assert strings[:8] == strings[8:] and len(strings) == 16
    assert answers["cuda"] == answers["cpu"] and answers["cpu"].count("\"response\"") == 8
    assert min(launches["cuda"]) > 0 and launches["cpu"] == (0, 0)


def test_offloaded_moments_rest_in_pinned_memory(rn):
    # chunks far below the model's size, so that the walk streams many pieces
    # through its two slots; the same steps with the moments on the card give
    # the same masters and moments, bit for bit
    import copy

    from hicom_tpu_torch.train.optimizer import build_optimizer
    from hicom_tpu_torch.train.train_step import create_train_state, make_train_step

    _, model, batch = _small_decoder_model(rn)
    states = []
    for offload in (True, False):
        m = copy.deepcopy(model)
        opt = build_optimizer(m, learning_rate=1e-3, weight_decay=0.05, total_steps=4,
                              tunable_parts="mm_projector,language_model", gradient_accumulation_steps=2)
        opt.chunk = 1 << 14
        states.append(create_train_state(m, opt, offload_optimizer=offload))
    offloaded, resident = states
    assert len(offloaded.optimizer.bounds) > 8
    step = make_train_step()
    for _ in range(4):
        for state in states:
            step(state, batch)
    home = offloaded.optimizer.home
    assert all(p.is_pinned() for pieces in home.pieces.values() for p in pieces)
    got, want = offloaded.optimizer.state_dict(), resident.optimizer.state_dict()
    assert offloaded.optimizer.count == 2 and got["exp_avg"]
    for kind in ("masters", "exp_avg", "exp_avg_sq"):
        for n, t in want[kind].items():
            assert got[kind][n].device == (t.device if kind == "masters" else torch.device("cpu")), n
            assert torch.equal(got[kind][n].to(t.device), t), (kind, n)


# --------------------------------------------------------------------------- #
# fp32 instances, and K1/K2 at the head dims that pad to 16, 48, 96 and 112
# --------------------------------------------------------------------------- #
#
# fp32: each element within 2^-14 |ref| + 2^-14 rms(ref) of the fp32 twin on the card (TF32 off), the fp32
# gate of chip_smoke.py: both sides keep every operand in fp32 and differ by the order of their fp32 sums and
# by exp2 against exp, far below it; TF32 or bf16 operands exceed it (tests/test_torch_fp32_kernels.py).


@pytest.fixture
def rn32(rn):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(5)
    return lambda *shape: torch.randn(*shape, generator=gen, device="cuda")


def _worst32(got, ref):
    """The largest ratio of an element's error to the fp32 gate (pass: <= 1)."""
    assert got.dtype == ref.dtype == torch.float32
    tol = 2**-14 * ref.abs() + 2**-14 * ref.square().mean().sqrt()
    return ((got - ref).abs() / tol).max().item()


def _valid_rows(out, ref, b, H, Lq, kl):
    if kl is None:
        return out, ref
    valid = (torch.arange(Lq, device="cuda")[None] < kl[:, None])[:, None, :].expand(b, H, Lq)
    return out[valid], ref[valid]


@pytest.mark.parametrize("bh,L,d", [
    (512, 729, 72),  # the so400m tower over 32 frames
    (8, 729, 16), (8, 200, 16), (8, 200, 96), (4, 200, 48), (4, 300, 112), (3, 200, 128),
])
def test_fullblock_fp32(rn32, bh, L, d):
    q, k, v = rn32(bh, L, d), rn32(bh, L, d), rn32(bh, L, d)
    before = fullblock_attention.launches
    out, lse = fullblock_attention(q, k, v, d**-0.5, 0.1)
    ref, ref_lse = flash_reference(q[:, None], k[:, None], v[:, None], None, d**-0.5, 0.1, False)
    assert fullblock_attention.launches == before + 1 and out.dtype == torch.float32
    assert _worst32(out, ref[:, 0]) <= 1 and (lse - ref_lse[:, 0]).abs().max().item() <= 1e-5


FP32_FORWARD = [
    (2, 28, 4, 743, 743, 128, True, [743, 700]),  # the decoder prefill
    (1, 9, 9, 32, 23328, 128, False, None),  # the global compressor at b 1: split, then the fp32 merge
    (2, 9, 9, 32, 23328, 128, False, None),  # and at b 2
    (2, 4, 4, 300, 300, 96, True, [217, 300]),  # d 96, non-grouped, causal, lengths
    (2, 6, 2, 130, 260, 112, True, [200, 260]),  # d 112, grouped, bottom-right diagonal
    (2, 4, 4, 200, 200, 48, False, [150, 200]),
    (1, 4, 2, 200, 200, 16, True, None),
]


@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens", FP32_FORWARD)
def test_flash_forward_fp32(rn32, b, H, KVH, Lq, Lk, d, causal, lens):
    q, k, v = rn32(b, H, Lq, d), rn32(b, KVH, Lk, d), rn32(b, KVH, Lk, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = flash_forward(q, k, v, kl, d**-0.5, 0.0, causal)
    ref, ref_lse = flash_reference(q, k, v, kl, d**-0.5, 0.0, causal)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert _worst32(*_valid_rows(out, ref, b, H, Lq, kl)) <= 1
    assert (lse - ref_lse).abs().max().item() <= 1e-5


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens", [
    (2, 4, 4, 37, 130, 32, False, [100, 130]),  # chunks wholly past kv_lengths
    (2, 4, 2, 300, 300, 64, True, [217, 300]),  # chunks all masked for some rows
    (1, 3, 3, 200, 729, 72, False, None),  # d 72, ragged last tile
])
def test_flash_forward_fp32_forced_split(rn32, b, H, KVH, Lq, Lk, d, causal, lens, n_split):
    q, k, v = rn32(b, H, Lq, d), rn32(b, KVH, Lk, d), rn32(b, KVH, Lk, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = _launch(q, k, v, kl, d**-0.5, 0.1, causal, n_split=n_split)
    ref, ref_lse = split_forward_reference(q.cpu(), k.cpu(), v.cpu(), kl.cpu() if kl is not None else None,
                                           d**-0.5, 0.1, causal, n_split)
    assert _worst32(out, ref.cuda()) <= 1 and (lse - ref_lse.cuda()).abs().max().item() <= 1e-5
    assert _worst32(out, flash_reference(q, k, v, kl, d**-0.5, 0.1, causal)[0]) <= 1


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("causal,lens", [(True, None), (False, [0, 60])])
def test_flash_forward_fp32_rows_without_keys(rn32, causal, lens, n_split):
    q, k, v = rn32(2, 2, 100, 32), rn32(2, 2, 60, 32), rn32(2, 2, 60, 32)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, _ = _launch(q, k, v, kl, 0.2, 0.0, causal, n_split=n_split)
    assert _worst32(out, flash_reference(q, k, v, kl, 0.2, 0.0, causal)[0]) <= 1


def test_fp32_partials_merge_to_fp32_rows(rn32):
    """K2's fp32 partials over a rank's chunk of the global compressor, merged
    by the merge kernel into fp32 rows: within 1e-5 of the twin relative to
    each element (a bf16 step would be 2^-9 off), no bf16 anywhere."""
    q, k, v = rn32(1, 9, 32, 128), rn32(1, 9, 2916, 128), rn32(1, 9, 2916, 128)
    parts = flash_forward_partials(q, k, v, None, 128**-0.5, 0.0, False)
    before = merge_partials.launches
    out, lse = merge_partials(*parts, torch.float32)
    assert merge_partials.launches == before + 1 and out.dtype == torch.float32
    ref, ref_lse = flash_reference(q, k, v, None, 128**-0.5, 0.0, False)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-6, atol=1e-5)
    n, rows, d = 5, 300, 72
    o, m, l = rn32(n, rows, d), rn32(n, rows) * 3, torch.rand(n, rows, device="cuda") * 10 + 1
    m[1] = -1e30
    m[2, :100] = float("-inf")
    got, got_lse = _launch_merge(o, m, l, torch.float32)
    want, want_lse = merge_partials_reference(o, m, l, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("thw,kernel,qk,dv", [
    ((32, 27, 27), (4, 3, 3), 1152, 1152),  # one 32-frame request
    ((64, 27, 27), (4, 3, 3), 1152, 1152),  # the batched request
    ((1, 27, 27), (1, 3, 3), 1152, 1152),  # an image
    ((8, 9, 12), (4, 3, 3), 64, 200),  # qk != dv
])
def test_tile_kernel_fp32(rn32, thw, kernel, qk, dv):
    t, h, w = thw
    kt, kh, kw = kernel
    key, val, q = rn32(t, h, w, qk), rn32(t, h, w, dv), rn32(t // kt, h // kh, w // kw, qk)
    before = fused_tile_attention.launches
    out = fused_tile_attention(q, key, val, kernel, qk**-0.5, 0.0)
    assert fused_tile_attention.launches == before + 1 and out.dtype == torch.float32
    assert _worst32(out, tile_reference(q, key, val, kernel, qk**-0.5, 0.0)) <= 1
    assert _worst32(out, chunked_tile_reference(q, key, val, kernel, qk**-0.5, 0.0)) <= 1


def test_tile_kernel_fp32_clip_scale_form(rn32):
    key, val, q = rn32(8, 27, 27, 1152), rn32(8, 27, 27, 1152), rn32(2, 9, 9, 1152)
    scale, bias = torch.exp(torch.tensor(-3.0, device="cuda")), torch.tensor(0.4, device="cuda")
    out = fused_tile_attention(q, key, val, (4, 3, 3), scale, bias)
    assert _worst32(out, tile_reference(q, key, val, (4, 3, 3), scale, bias)) <= 1


@pytest.mark.parametrize("bh,L,d", [(8, 200, 16), (8, 729, 16), (8, 200, 96), (4, 200, 48), (4, 300, 112)])
def test_fullblock_new_widths(rn, bh, L, d):
    q, k, v = rn(bh, L, d), rn(bh, L, d), rn(bh, L, d)
    out, lse = fullblock_attention(q, k, v, d**-0.5, 0.1)
    ref, ref_lse = flash_reference(q[:, None], k[:, None], v[:, None], None, d**-0.5, 0.1, False)
    assert _worst(out, ref[:, 0]) <= 1 and (lse - ref_lse[:, 0]).abs().max().item() <= 1e-3


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens", [
    (2, 4, 4, 300, 300, 96, True, [217, 300]),
    (2, 6, 2, 130, 260, 112, True, [200, 260]),
    (2, 4, 4, 200, 200, 48, False, [150, 200]),
    (1, 4, 2, 200, 200, 16, True, None),
    (1, 9, 9, 32, 5000, 96, False, None),
])
def test_flash_forward_new_widths(rn, b, H, KVH, Lq, Lk, d, causal, lens, n_split):
    q, k, v = rn(b, H, Lq, d), rn(b, KVH, Lk, d), rn(b, KVH, Lk, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = _launch(q, k, v, kl, d**-0.5, 0.0, causal, n_split=n_split)
    ref, ref_lse = flash_reference(q, k, v, kl, d**-0.5, 0.0, causal)
    assert _worst(*_valid_rows(out, ref, b, H, Lq, kl)) <= 1


# --------------------------------------------------------------------------- #
# the flash backward in fp32 (flash_bwd_f32.cu) and in bf16 at head dims 16, 48, 96 and 112
# --------------------------------------------------------------------------- #

FP32_BACKWARD = [
    (2, 28, 4, 743, 743, 128, True, [743, 700], 0.0),  # the decoder prefill (K6 split in 3)
    (2, 9, 9, 32, 23328, 128, False, None, 0.0),  # the global compressor at b 2 (K5 split in 14)
    (2, 16, 16, 729, 729, 72, False, None, 0.1),  # the tower's width
    (2, 4, 4, 300, 300, 96, True, [217, 300], 0.3),  # d 96, causal, lengths
    (2, 6, 2, 130, 260, 112, True, [200, 260], 0.0),  # d 112, grouped, bottom-right diagonal
    (2, 4, 4, 200, 200, 48, False, [150, 200], -0.2),
    (1, 4, 2, 200, 200, 16, True, None, 0.0),
    (2, 4, 4, 37, 130, 32, False, [0, 130], 0.0),  # a row with no valid key, one query tile of 32 rows
]


@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens,bias", FP32_BACKWARD)
def test_flash_backward_fp32(rn32, b, H, KVH, Lq, Lk, d, causal, lens, bias):
    q, k, v, do = rn32(b, H, Lq, d), rn32(b, KVH, Lk, d), rn32(b, KVH, Lk, d), rn32(b, H, Lq, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = flash_forward(q, k, v, kl, d**-0.5, bias, causal)
    before = flash_backward.launches
    got = flash_backward(q, k, v, kl, out, lse, do, d**-0.5, bias, causal)
    assert flash_backward.launches == before + 1 and all(g.dtype == torch.float32 for g in got)
    ref = flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, bias, causal)
    assert max(_worst32(g, r) for g, r in zip(got, ref)) <= 1


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens", [
    (2, 9, 9, 32, 3000, 128, False, None),  # the global compressor's 32-row query blocks
    (2, 6, 2, 150, 150, 96, True, [150, 97]),  # GQA, chunks and unit ranges wholly masked
    (1, 4, 4, 70, 200, 16, True, None),
])
def test_backward_fp32_forced_split(rn32, b, H, KVH, Lq, Lk, d, causal, lens, n_split):
    """K5's key chunks and K6's unit ranges in fp32, summed by the fp32 sum
    pass: the split twins' gradients (the same chunks in plain PyTorch on the
    CPU) and the unsplit twin's within the fp32 gate."""
    q, k, v, do = rn32(b, H, Lq, d), rn32(b, KVH, Lk, d), rn32(b, KVH, Lk, d), rn32(b, H, Lq, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = flash_forward(q, k, v, kl, d**-0.5, 0.1, causal)
    ops = backward_operands(q, k, v, kl, out, lse, do)
    dq = _launch_dq(*ops, d**-0.5, 0.1, causal, n_split=n_split)
    dk, dv = _launch_dkv(*ops, d**-0.5, 0.1, causal, n_split=n_split)
    cpu = [t.cpu() if t is not None else None for t in (q, k, v, kl, out, lse, do)]
    want_dq = split_dq_reference(*cpu, d**-0.5, 0.1, causal, n_split)
    want_dk, want_dv = split_dkv_reference(*cpu, d**-0.5, 0.1, causal, n_split)
    ref = flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, 0.1, causal)
    for got, split, whole in zip((dq, dk, dv), (want_dq, want_dk, want_dv), ref):
        assert got.dtype == torch.float32
        assert _worst32(got, split.cuda()) <= 1 and _worst32(got, whole) <= 1


def test_sum_pass_writes_fp32(rn32):
    """The sum pass in fp32 (K5's dQ, K6's dK and dV in one launch): the
    chunks' sum with no bf16 step, within the fp32 gate of the twin."""
    part, part2 = rn32(14, 2, 9, 32, 128), rn32(3, 2, 4, 100, 72)
    dq, = _launch_part_sum((part, 0.125), dtype=torch.float32)
    assert dq.dtype == torch.float32 and _worst32(dq, sum_partials_reference(part, 0.125, torch.float32)) <= 1
    dk, dv = _launch_part_sum((part2, 0.125), (part2 * 2, 1.0), dtype=torch.float32)
    assert _worst32(dk, sum_partials_reference(part2, 0.125, torch.float32)) <= 1
    assert _worst32(dv, sum_partials_reference(part2 * 2, 1.0, torch.float32)) <= 1


def test_fp32_function_backward_runs_the_kernels(rn32):
    b, H, KVH, L, d = 2, 8, 2, 150, 128
    q, k, v, do = rn32(b, H, L, d), rn32(b, KVH, L, d), rn32(b, KVH, L, d), rn32(b, H, L, d)
    kl = torch.tensor([150, 120], device="cuda", dtype=torch.int32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (flash_forward.launches, flash_backward.launches)
    out = flash_attention_gqa(*leaves, is_causal=True, kv_lengths=kl)
    grads = torch.autograd.grad(out, leaves, do)
    assert (flash_forward.launches, flash_backward.launches) == (before[0] + 1, before[1] + 1)
    _, lse = flash_reference(q, k, v, kl, d**-0.5, 0.0, True)
    ref = flash_backward_reference(q, k, v, kl, out.detach(), lse, do, d**-0.5, 0.0, True)
    assert max(_worst32(g, r) for g, r in zip(grads, ref)) <= 1


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens,bias", [
    (2, 4, 4, 300, 300, 96, True, [217, 300], 0.3),
    (2, 6, 2, 130, 260, 112, True, [200, 260], 0.0),
    (2, 4, 4, 200, 200, 48, False, [150, 200], -0.2),
    (1, 4, 2, 200, 200, 16, True, None, 0.0),
    (2, 9, 9, 32, 5000, 96, False, None, 0.0),
    (2, 8, 8, 729, 729, 16, False, None, 0.0),
])
def test_flash_backward_new_widths(rn, b, H, KVH, Lq, Lk, d, causal, lens, bias, n_split):
    q, k, v, do = rn(b, H, Lq, d), rn(b, KVH, Lk, d), rn(b, KVH, Lk, d), rn(b, H, Lq, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = flash_forward(q, k, v, kl, d**-0.5, bias, causal)
    ops = backward_operands(q, k, v, kl, out, lse, do)
    got = (_launch_dq(*ops, d**-0.5, bias, causal, n_split=n_split),) + _launch_dkv(*ops, d**-0.5, bias, causal,
                                                                                    n_split=n_split)
    ref = flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, bias, causal)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert max(_worst(g, r) for g, r in zip(got, ref)) <= 1


def fp32_cli_stage2(root: str, device: str = "cuda"):
    """``train.cli`` stage 2 with ``--dtype float32`` at tiny widths whose
    attention takes the kernels: a SigLIP tower of head dim 16 over 168 x 168
    frames (144 tokens: K1), a non-grouped decoder of 2 heads of 96 over 16
    frames' 96 visual tokens and a 64-token bucket (K2 forward, K5/K6 backward)
    and the global compressor (32 queries over 16 x 144 keys: K5/K6). Inputs
    from ``chip_smoke.write_cli_inputs``. Returns (losses, K5/K6 launches)."""
    import dataclasses
    import json
    import os

    import chip_smoke
    from hicom_tpu_torch import config as tcfg
    from hicom_tpu_torch.train import cli

    c = tcfg.tiny_test_config(use_guide="direct", dtype="float32")
    cfg = c.replace(text_config=dataclasses.replace(c.text_config, hidden_size=192, num_attention_heads=2,
                                                    num_key_value_heads=2, head_dim=96),
                    vision_config=dataclasses.replace(c.vision_config, image_size=168))
    paths = chip_smoke.write_cli_inputs(root, cfg, frames=16, rows=4)
    tok = chip_smoke.WordTokenizer(cfg.text_config.vocab_size)
    guide_tok = chip_smoke.WordTokenizer(cfg.guide_text_config.vocab_size, cfg.guide_text_config.max_position_embeddings)
    out = os.path.join(root, "stage2")
    args = cli.build_parser().parse_args([
        "--model-path", paths["llm"], "--vision-tower", paths["tower"], "--mm-projector-type", "local43_global32",
        "--use-guide", "direct", "--data-path", paths["data"], "--data-folder", root, "--num-frames", "16",
        "--per-device-train-batch-size", "2", "--logging-steps", "1", "--device", device, "--dtype", "float32",
        "--mm-tunable-parts", "mm_projector", "--learning-rate", "1e-3", "--pretrain-weights", paths["bin"],
        "--output-dir", out])
    before = flash_backward.launches
    cli.run(args, tok, guide_tok)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f], flash_backward.launches - before


def test_train_cli_stage2_in_fp32_on_the_card(tmp_path):
    """2 steps of fp32 stage 2 through the CLI on the card: finite losses, and
    K5/K6 (their fp32 instance) once per decoder layer and once for the global
    compressor each step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    losses, launched = fp32_cli_stage2(str(tmp_path))
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert launched == 2 * (2 + 1)


# --------------------------------------------------------------------------- #
# head dims past 128: the 192 and 256 instances of K1/K2 and K5/K6, in bf16 and fp32
# --------------------------------------------------------------------------- #

WIDE_DTYPES = {"bf16": (torch.bfloat16, _worst), "fp32": (torch.float32, _worst32)}


def _wide_rn(dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(19)
    return lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
@pytest.mark.parametrize("bh,L,d", [(4, 300, 136), (4, 200, 192), (4, 300, 256), (64, 729, 256)])
def test_fullblock_wide_heads(rn, tag, bh, L, d):
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    q, k, v = r(bh, L, d), r(bh, L, d), r(bh, L, d)
    before = fullblock_attention.launches
    out, lse = fullblock_attention(q, k, v, d**-0.5, 0.1)
    ref, ref_lse = flash_reference(q[:, None], k[:, None], v[:, None], None, d**-0.5, 0.1, False)
    assert fullblock_attention.launches == before + 1 and out.dtype == dtype
    assert worst(out, ref[:, 0]) <= 1 and (lse - ref_lse[:, 0]).abs().max().item() <= 1e-3


WIDE_FORWARD = [
    (2, 14, 2, 300, 300, 256, True, [300, 217]),  # the d-256 decoder's heads, GQA 7:1, causal, lengths
    (2, 4, 4, 200, 200, 192, False, [150, 200]),
    (1, 4, 4, 200, 260, 136, True, None),  # d 136 on the 192 instance, bottom-right diagonal
    (1, 9, 9, 32, 3000, 256, False, None),  # 32 queries over many keys: split by default
    (2, 7, 1, 150, 150, 200, True, [150, 97]),  # d 200 on the 256 instance
]


@pytest.mark.parametrize("n_split", [None, 1, 3])
@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens", WIDE_FORWARD)
def test_flash_forward_wide_heads(rn, tag, b, H, KVH, Lq, Lk, d, causal, lens, n_split):
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    q, k, v = r(b, H, Lq, d), r(b, KVH, Lk, d), r(b, KVH, Lk, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = _launch(q, k, v, kl, d**-0.5, 0.0, causal, n_split=n_split)
    ref, ref_lse = flash_reference(q, k, v, kl, d**-0.5, 0.0, causal)
    assert out.dtype == dtype
    assert worst(*_valid_rows(out, ref, b, H, Lq, kl)) <= 1
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    if n_split is not None and n_split > 1:
        cpu = [t.cpu() if t is not None else None for t in (q, k, v, kl)]
        split, _ = split_forward_reference(*cpu, d**-0.5, 0.0, causal, n_split)
        assert worst(*_valid_rows(out, split.cuda(), b, H, Lq, kl)) <= 1


@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
def test_forward_partials_merge_wide_heads(rn, tag):
    """K2's partials alone at d 256 and the merge kernel over two key halves
    (as a two-rank split-key call gives them), in the caller's dtype."""
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    q, k, v = r(1, 8, 32, 256), r(1, 8, 2000, 256), r(1, 8, 2000, 256)
    halves = [flash_forward_partials(q, k[:, :, i:i + 1000], v[:, :, i:i + 1000], None, 256**-0.5, 0.0, False)
              for i in (0, 1000)]
    before = merge_partials.launches
    out, lse = merge_partials(*(torch.cat(x) for x in zip(*halves)), dtype)
    assert merge_partials.launches == before + 1 and out.dtype == dtype
    ref, ref_lse = flash_reference(q, k, v, None, 256**-0.5, 0.0, False)
    assert worst(out, ref) <= 1 and (lse - ref_lse).abs().max().item() <= 1e-3


WIDE_BACKWARD = [
    (2, 14, 2, 300, 300, 256, True, [300, 217], 0.0),  # the d-256 decoder's heads
    (2, 4, 4, 200, 200, 192, False, [150, 200], 0.1),
    (1, 4, 4, 130, 260, 136, True, None, -0.2),  # d 136 on the 192 instance, bottom-right diagonal
    (2, 9, 9, 32, 3000, 256, False, None, 0.0),  # 32-row query blocks, K5 split by default
    (2, 7, 1, 150, 150, 200, True, [150, 97], 0.0),  # d 200 on the 256 instance
]


@pytest.mark.parametrize("n_split", [None, 1, 3])
@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens,bias", WIDE_BACKWARD)
def test_flash_backward_wide_heads(rn, tag, b, H, KVH, Lq, Lk, d, causal, lens, bias, n_split):
    """K5 (Q and dO from shared memory past 128) and K6 (two warpgroups past
    128) against the unsplit twin, and with forced splits against the split
    twins too (the same chunks and unit ranges, then the sum pass)."""
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    q, k, v, do = r(b, H, Lq, d), r(b, KVH, Lk, d), r(b, KVH, Lk, d), r(b, H, Lq, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = flash_forward(q, k, v, kl, d**-0.5, bias, causal)
    ops = backward_operands(q, k, v, kl, out, lse, do)
    got = (_launch_dq(*ops, d**-0.5, bias, causal, n_split=n_split),) + _launch_dkv(*ops, d**-0.5, bias, causal,
                                                                                    n_split=n_split)
    ref = flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, bias, causal)
    assert all(g.dtype == dtype for g in got)
    assert max(worst(g, r) for g, r in zip(got, ref)) <= 1
    if n_split is not None and n_split > 1:
        cpu = [t.cpu() if t is not None else None for t in (q, k, v, kl, out, lse, do)]
        split = (split_dq_reference(*cpu, d**-0.5, bias, causal, n_split),) + split_dkv_reference(
            *cpu, d**-0.5, bias, causal, n_split)
        assert max(worst(g, s.cuda()) for g, s in zip(got, split)) <= 1


@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
def test_wide_function_backward_runs_the_kernels(rn, tag):
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    b, H, KVH, L, d = 2, 14, 2, 150, 256
    q, k, v, do = r(b, H, L, d), r(b, KVH, L, d), r(b, KVH, L, d), r(b, H, L, d)
    kl = torch.tensor([150, 120], device="cuda", dtype=torch.int32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (flash_forward.launches, flash_backward.launches)
    out = flash_attention_gqa(*leaves, is_causal=True, kv_lengths=kl)
    grads = torch.autograd.grad(out, leaves, do)
    assert (flash_forward.launches, flash_backward.launches) == (before[0] + 1, before[1] + 1)
    _, lse = flash_reference(q, k, v, kl, d**-0.5, 0.0, True)
    ref = flash_backward_reference(q, k, v, kl, out.detach(), lse.float(), do, d**-0.5, 0.0, True)
    assert max(worst(g, r) for g, r in zip(grads, ref)) <= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sum_pass_wide_heads(rn, dtype):
    """The sum pass over d-256 rows: K5's dQ chunks and K6's dK/dV ranges."""
    gen = torch.Generator("cuda").manual_seed(4)
    part, part2 = (torch.randn(n, 2, 9, 32, 256, generator=gen, device="cuda") for n in (14, 3))
    worst = _worst if dtype == torch.bfloat16 else _worst32
    dq, = _launch_part_sum((part, 0.0625), dtype=dtype)
    assert dq.dtype == dtype and worst(dq, sum_partials_reference(part, 0.0625, dtype)) <= 1
    dk, dv = _launch_part_sum((part2, 0.0625), (part2 * 2, 1.0), dtype=dtype)
    assert worst(dk, sum_partials_reference(part2, 0.0625, dtype)) <= 1
    assert worst(dv, sum_partials_reference(part2 * 2, 1.0, dtype)) <= 1


def _tiny_d256_config(dtype: str):
    """``tiny_test_config`` with the decoder at 2 query heads and 1 kv head of
    256, over 12 frames of 168 x 168 (144 tower tokens: K1; a 143-token
    prefill: K2 at d 256; the global compressor's 32 queries over 12 x 144
    keys: K2 at d 16)."""
    import dataclasses

    from hicom_tpu_torch import config as tcfg

    c = tcfg.tiny_test_config(use_guide="direct", dtype=dtype)
    return c.replace(text_config=dataclasses.replace(c.text_config, num_attention_heads=2, num_key_value_heads=1,
                                                     head_dim=256), num_frames=12,
                     vision_config=dataclasses.replace(c.vision_config, image_size=168))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_d256_tiny_model_on_the_card(rn, dtype):
    """A tiny HICom whose decoder has heads of 256, on the card's kernels
    against the plain path on the card: the single request's last-token
    logits (at the type's gate), 8 greedy ids (equal, or first apart at a
    near-tie), K2 launched at each decoder layer's prefill with the one-token
    steps on K3's plain route; one stage-2 loss's trained gradients, K5/K6
    launched once per decoder layer and once for the global compressor
    (each tensor within 5% of its norm in bf16; at the fp32 gate in fp32; a
    gradient the softmax cancels held below the noise of the largest)."""
    _tiny_model_on_the_card(_tiny_d256_config(dtype), dtype)


def _tiny_model_on_the_card(cfg, dtype: str, compressor_kernel: bool = True):
    """The checks of :func:`test_d256_tiny_model_on_the_card` on ``cfg``;
    ``compressor_kernel``: whether JAX's rule sends the global compressor to
    K2 (else it takes the plain path and launches no flash kernel)."""
    import chip_smoke as cs
    from hicom_tpu_torch.api import HICom, build_model
    from hicom_tpu_torch.ops.cuda_build import plain_route
    from hicom_tpu_torch.train.optimizer import build_optimizer
    from hicom_tpu_torch.train.train_step import batch_to_device, make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    fp32 = dtype == "float32"
    model = build_model(cfg, device="cuda", seed=0)
    cs.norms_at_one(model)
    hc = HICom(config=cfg, model=model, eos_token_id=-1, cache_len=512)
    _, single = cs.make_requests(cfg)
    plain_route.reset()
    before = flash_forward.launches
    got, _ = cs.greedy_with_tops(hc, single, 8)
    layers = cfg.text_config.num_hidden_layers
    # each decoder layer's prefill, the global compressor
    assert flash_forward.launches - before == layers + compressor_kernel
    assert plain_route.counts["K3"] == 7 * layers  # the 7 one-token steps after the prefill
    with cs.plain_path():
        ref, tops = cs.greedy_with_tops(hc, single, 8)
    div = cs.first_divergence(got, ref, tops)
    assert div is None or div[1] <= cs.NEAR_TIE, (got, ref)
    got_l = cs.last_logits(model, cs.with_mask(single))
    with cs.plain_path():
        ref_l = cs.last_logits(model, cs.with_mask(single))
    assert cs.agreement(got_l, ref_l, cs.FP32_GATE if fp32 else cs.BF16_GATE)[1] <= 1
    plain_route.reset()

    build_optimizer(model, learning_rate=1e-3, tunable_parts="mm_projector", use_guide="direct").init(model)
    batch = batch_to_device(cs.make_train_batch(cfg), torch.device("cuda"), getattr(torch, dtype))
    trained = [n for n, p in model.named_parameters() if p.requires_grad]

    def grads():
        for p in model.parameters():
            p.grad = None
        make_loss_fn(model)(batch)[0].backward()
        return {n: p.grad.float() if p.grad is not None else torch.zeros_like(p, dtype=torch.float32)
                for n, p in model.named_parameters() if n in trained}

    before = flash_backward.launches
    got_g = grads()
    assert flash_backward.launches - before == layers + compressor_kernel
    with cs.plain_path():
        ref_g = grads()
    noise = (2**-20 if fp32 else 2**-16) * max(float(g.abs().max()) for g in ref_g.values())
    for n in trained:
        if float(ref_g[n].abs().max()) <= noise:
            assert float(got_g[n].abs().max()) <= noise, n
        elif fp32:
            assert cs.agreement(got_g[n], ref_g[n], cs.FP32_GATE)[1] <= 1, n
        else:
            assert float((got_g[n] - ref_g[n]).norm()) <= 0.05 * float(ref_g[n].norm()), n


# --------------------------------------------------------------------------- #
# head dims past 256: flash_wide.cu (bf16) and flash_wide_f32.cu (fp32), K1/K2 and K5/K6 with the head dim a
# runtime argument, in column blocks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
@pytest.mark.parametrize("bh,L,d", [(4, 300, 264), (8, 729, 288), (4, 200, 320), (4, 300, 512), (2, 200, 1024)])
def test_fullblock_past_256(rn, tag, bh, L, d):
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    q, k, v = r(bh, L, d), r(bh, L, d), r(bh, L, d)
    before = fullblock_attention.launches
    out, lse = fullblock_attention(q, k, v, d**-0.5, 0.1)
    ref, ref_lse = flash_reference(q[:, None], k[:, None], v[:, None], None, d**-0.5, 0.1, False)
    assert fullblock_attention.launches == before + 1 and out.dtype == dtype
    assert worst(out, ref[:, 0]) <= 1 and (lse - ref_lse[:, 0]).abs().max().item() <= 1e-3


PAST_256_FORWARD = [
    (2, 7, 1, 300, 300, 512, True, [300, 217]),  # the d-512 decoder's heads, GQA 7:1, causal, lengths
    (2, 8, 2, 200, 200, 320, True, None),
    (2, 4, 4, 200, 200, 384, False, [150, 200]),
    (1, 4, 1, 150, 260, 1024, True, [260]),  # bottom-right diagonal, four column blocks
    (1, 4, 4, 32, 3000, 512, False, None),  # 32 queries over many keys: split by default
    (1, 2, 2, 100, 100, 2048, True, None),
]


@pytest.mark.parametrize("n_split", [None, 1, 3])
@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens", PAST_256_FORWARD)
def test_flash_forward_past_256(rn, tag, b, H, KVH, Lq, Lk, d, causal, lens, n_split):
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    q, k, v = r(b, H, Lq, d), r(b, KVH, Lk, d), r(b, KVH, Lk, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = _launch(q, k, v, kl, d**-0.5, 0.2, causal, n_split=n_split)
    ref, ref_lse = flash_reference(q, k, v, kl, d**-0.5, 0.2, causal)
    assert out.dtype == dtype
    assert worst(*_valid_rows(out, ref, b, H, Lq, kl)) <= 1
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    if n_split is not None and n_split > 1:
        cpu = [t.cpu() if t is not None else None for t in (q, k, v, kl)]
        split, _ = split_forward_reference(*cpu, d**-0.5, 0.2, causal, n_split)
        assert worst(*_valid_rows(out, split.cuda(), b, H, Lq, kl)) <= 1


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("causal,lens", [(True, None), (False, [0, 60])])
def test_flash_forward_past_256_rows_without_keys(rn, causal, lens, n_split):
    """Rows with no valid key (Lq > Lk causal; a batch row of kv length 0)
    end as the twin's: the mean of every value."""
    r = _wide_rn(torch.float32)
    q, k, v = r(2, 2, 200, 320), r(2, 2, 80, 320), r(2, 2, 80, 320)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = _launch(q, k, v, kl, 320**-0.5, 0.0, causal, n_split=n_split)
    ref, ref_lse = flash_reference(q, k, v, kl, 320**-0.5, 0.0, causal)
    assert _worst32(out, ref) <= 1 and (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
@pytest.mark.parametrize("d", [512, 1024])
def test_forward_partials_merge_past_256(rn, tag, d):
    """K2's partials alone past 256 and the merge kernel over two key halves,
    in the caller's dtype, on rows of 512 and 1,024 columns."""
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    q, k, v = r(1, 4, 32, d), r(1, 4, 2000, d), r(1, 4, 2000, d)
    halves = [flash_forward_partials(q, k[:, :, i:i + 1000], v[:, :, i:i + 1000], None, d**-0.5, 0.0, False)
              for i in (0, 1000)]
    before = merge_partials.launches
    out, lse = merge_partials(*(torch.cat(x) for x in zip(*halves)), dtype)
    assert merge_partials.launches == before + 1 and out.dtype == dtype
    ref, ref_lse = flash_reference(q, k, v, None, d**-0.5, 0.0, False)
    assert worst(out, ref) <= 1 and (lse - ref_lse).abs().max().item() <= 1e-3


PAST_256_BACKWARD = [
    (2, 7, 1, 300, 300, 512, True, [300, 217], 0.0),  # the d-512 decoder's heads
    (2, 8, 2, 200, 200, 320, True, None, 0.1),
    (2, 4, 4, 200, 200, 288, False, [150, 200], -0.2),
    (1, 4, 1, 130, 260, 1024, True, [260], 0.0),  # bottom-right diagonal
    (2, 4, 4, 32, 2000, 512, False, None, 0.0),  # 32-row query blocks, K5 split by default
]


@pytest.mark.parametrize("n_split", [None, 1, 3])
@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
@pytest.mark.parametrize("b,H,KVH,Lq,Lk,d,causal,lens,bias", PAST_256_BACKWARD)
def test_flash_backward_past_256(rn, tag, b, H, KVH, Lq, Lk, d, causal, lens, bias, n_split):
    """K5 and K6 in column blocks against the unsplit twin, and with forced
    splits against the split twins (the same chunks and unit ranges, then the
    sum pass)."""
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    q, k, v, do = r(b, H, Lq, d), r(b, KVH, Lk, d), r(b, KVH, Lk, d), r(b, H, Lq, d)
    kl = torch.tensor(lens, device="cuda", dtype=torch.int32) if lens else None
    out, lse = flash_forward(q, k, v, kl, d**-0.5, bias, causal)
    ops = backward_operands(q, k, v, kl, out, lse, do)
    got = (_launch_dq(*ops, d**-0.5, bias, causal, n_split=n_split),) + _launch_dkv(*ops, d**-0.5, bias, causal,
                                                                                    n_split=n_split)
    ref = flash_backward_reference(q, k, v, kl, out, lse, do, d**-0.5, bias, causal)
    assert all(g.dtype == dtype for g in got)
    assert max(worst(g, r) for g, r in zip(got, ref)) <= 1
    if n_split is not None and n_split > 1:
        cpu = [t.cpu() if t is not None else None for t in (q, k, v, kl, out, lse, do)]
        split = (split_dq_reference(*cpu, d**-0.5, bias, causal, n_split),) + split_dkv_reference(
            *cpu, d**-0.5, bias, causal, n_split)
        assert max(worst(g, s.cuda()) for g, s in zip(got, split)) <= 1


@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
@pytest.mark.parametrize("d", [288, 512])
def test_past_256_function_backward_runs_the_kernels(rn, tag, d):
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    b, H, KVH, L = 2, 7, 1, 150
    q, k, v, do = r(b, H, L, d), r(b, KVH, L, d), r(b, KVH, L, d), r(b, H, L, d)
    kl = torch.tensor([150, 120], device="cuda", dtype=torch.int32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (flash_forward.launches, flash_backward.launches)
    out = flash_attention_gqa(*leaves, is_causal=True, kv_lengths=kl)
    grads = torch.autograd.grad(out, leaves, do)
    assert (flash_forward.launches, flash_backward.launches) == (before[0] + 1, before[1] + 1)
    _, lse = flash_reference(q, k, v, kl, d**-0.5, 0.0, True)
    ref = flash_backward_reference(q, k, v, kl, out.detach(), lse.float(), do, d**-0.5, 0.0, True)
    assert max(worst(g, r) for g, r in zip(grads, ref)) <= 1


def _tiny_d512_config(dtype: str):
    """:func:`_tiny_d256_config` with the decoder at 2 query heads and 1 kv
    head of 512 and the tower at one head of 288 (hidden 288, and the guide's
    projection with it: the 144 tower tokens take K1 at d 288 by JAX's
    one-block rule)."""
    import dataclasses

    c = _tiny_d256_config(dtype)
    return c.replace(text_config=dataclasses.replace(c.text_config, head_dim=512),
                     vision_config=dataclasses.replace(c.vision_config, hidden_size=288, num_attention_heads=1),
                     guide_text_config=dataclasses.replace(c.guide_text_config, projection_size=288))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_d512_tiny_model_on_the_card(rn, dtype):
    """The checks of :func:`test_d256_tiny_model_on_the_card` on a tiny
    HICom whose decoder has heads of 512 and whose tower has a head of 288:
    K1 at d 288, K2 at d 512, K5/K6's wide kernels in the backward. Its
    global compressor (2 heads of 144 over 1,728 keys) takes the plain path by
    JAX's rule, so the flash kernels launch once per decoder layer."""
    before = fullblock_attention.launches
    _tiny_model_on_the_card(_tiny_d512_config(dtype), dtype, compressor_kernel=False)
    assert fullblock_attention.launches > before


# --------------------------------------------------------------------------- #
# the wide forward and K6 in thread-block clusters (3xTF32 in fp32): the cluster's edges, passes past the
# largest cluster, and a refused cluster
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n_split", [1, 3, 7])
@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
@pytest.mark.parametrize("d", [1024, 1032, 1088, 2048])
def test_wide_cluster_edges(rn, tag, d, n_split):
    """d 1,024: K6 in one cluster of exactly 8 CTAs (the forward 4); d 1,032
    and 1,088, just past it: K6 in two passes of 5, the forward in one
    cluster of 5 with 4 / 3-chunk shares (1,032's last chunk 8 columns
    wide); d 2,048: the forward's 8, K6's two passes of 8. Forward and dK/dV
    against the twins, and at 3 and 7 splits against the split twins."""
    from hicom_tpu_torch.ops.flash_attention import wide_cluster

    assert wide_cluster(d, "dkv") == {1024: (8, 1), 1032: (5, 2), 1088: (5, 2), 2048: (8, 2)}[d]
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    b, H, KVH, L = 2, 4, 1, 130
    q, k, v, do = r(b, H, L, d), r(b, KVH, L, d), r(b, KVH, L, d), r(b, H, L, d)
    kl = torch.tensor([130, 75], device="cuda", dtype=torch.int32)
    out, lse = _launch(q, k, v, kl, d**-0.5, 0.1, True, n_split=n_split)
    ref, ref_lse = flash_reference(q, k, v, kl, d**-0.5, 0.1, True)
    assert worst(*_valid_rows(out, ref, b, H, L, kl)) <= 1
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    ops = backward_operands(q, k, v, kl, ref, ref_lse.float(), do)
    got = _launch_dkv(*ops, d**-0.5, 0.1, True, n_split=n_split)
    _, dk, dv = flash_backward_reference(q, k, v, kl, ref, ref_lse.float(), do, d**-0.5, 0.1, True)
    assert max(worst(got[0], dk), worst(got[1], dv)) <= 1
    if n_split > 1:
        cpu = [t.cpu() for t in (q, k, v, kl)]
        split, _ = split_forward_reference(*cpu, d**-0.5, 0.1, True, n_split)
        assert worst(*_valid_rows(out, split.cuda(), b, H, L, kl)) <= 1
        sdk, sdv = split_dkv_reference(*cpu, ref.cpu(), ref_lse.float().cpu(), do.cpu(), d**-0.5, 0.1, True, n_split)
        assert max(worst(got[0], sdk.cuda()), worst(got[1], sdv.cuda())) <= 1


@pytest.fixture
def max_cluster():
    """Set the largest cluster of the wide forward and K6 for one test."""
    from hicom_tpu_torch.ops.flash_attention import WIDE_MAX_CLUSTER, set_wide_max_cluster

    yield set_wide_max_cluster
    set_wide_max_cluster(WIDE_MAX_CLUSTER)


@pytest.mark.parametrize("cap", [1, 2, 3])
@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
def test_wide_passes_past_a_smaller_cluster(rn, max_cluster, tag, cap):
    """With the largest cluster cut to 1, 2 or 3 CTAs the forward and K6 at
    d 512 / 1,024 take passes (1: a pass per column block, S in each from
    the whole d; the forward then streams Q with K) and agree with the
    twins."""
    max_cluster(cap)
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    for d in (512, 1024):
        b, H, KVH, L = 1, 4, 2, 150
        q, k, v, do = r(b, H, L, d), r(b, KVH, L, d), r(b, KVH, L, d), r(b, H, L, d)
        kl = torch.tensor([140], device="cuda", dtype=torch.int32)
        out, lse = _launch(q, k, v, kl, d**-0.5, 0.0, True)
        ref, ref_lse = flash_reference(q, k, v, kl, d**-0.5, 0.0, True)
        assert worst(*_valid_rows(out, ref, b, H, L, kl)) <= 1
        assert (lse - ref_lse).abs().max().item() <= 1e-3
        ops = backward_operands(q, k, v, kl, ref, ref_lse.float(), do)
        got = _launch_dkv(*ops, d**-0.5, 0.0, True)
        _, dk, dv = flash_backward_reference(q, k, v, kl, ref, ref_lse.float(), do, d**-0.5, 0.0, True)
        assert max(worst(got[0], dk), worst(got[1], dv)) <= 1


@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
def test_refused_cluster_raises_in_the_wrapper(rn, max_cluster, tag):
    """A cluster the card cannot schedule is refused at launch and raises in
    the wrapper, with no plain path: K6 at d 2,048 in one cluster of 16 CTAs
    (past the portable 8, without the non-portable opt-in), and at d 2,176 in
    one of 17 (past any cluster of the card). At the default the same calls
    launch."""
    dtype, _ = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    for d, cap in ((2048, 16), (2176, 32)):
        q, k, v, do = r(1, 2, 64, d), r(1, 1, 64, d), r(1, 1, 64, d), r(1, 2, 64, d)
        out, lse = flash_forward(q, k, v, None, d**-0.5, 0.0, True)
        ops = backward_operands(q, k, v, None, out, lse, do)
        max_cluster(cap)
        with pytest.raises(RuntimeError, match="hicom_flash_bwd_dkv_wide"):
            _launch_dkv(*ops, d**-0.5, 0.0, True)
        max_cluster(8)
        dk, dv = _launch_dkv(*ops, d**-0.5, 0.0, True)
        torch.cuda.synchronize()
        assert dk.isfinite().all() and dv.isfinite().all()


# --------------------------------------------------------------------------- #
# K5 past 256 in clusters (S and dP once over the cluster's shares, 3xTF32 in fp32), and the bf16 forward at
# the padded widths 192 / 256 (a producer warpgroup, K and V rings of their own)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n_split", [1, 3, 7])
@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
@pytest.mark.parametrize("d", [264, 320, 1024, 1032, 1088, 2048])
def test_clustered_dq_edges(rn, tag, d, n_split):
    """K5's clusters at their edges: d 264 and 320 (two CTAs, shares of 2
    and 3 chunks, 264's last chunk 8 columns wide), 1,024 (4), 1,032 and
    1,088 (5, the last CTA's block 1 chunk), 2,048 (8, the largest). dQ
    against the twin, and at 3 and 7 splits against the split twin."""
    from hicom_tpu_torch.ops.flash_attention import wide_cluster

    assert wide_cluster(d, "dq") == {264: (2, 1), 320: (2, 1), 1024: (4, 1), 1032: (5, 1), 1088: (5, 1),
                                     2048: (8, 1)}[d]
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    b, H, KVH, L = 2, 4, 1, 130
    q, k, v, do = r(b, H, L, d), r(b, KVH, L, d), r(b, KVH, L, d), r(b, H, L, d)
    kl = torch.tensor([130, 75], device="cuda", dtype=torch.int32)
    ref, ref_lse = flash_reference(q, k, v, kl, d**-0.5, 0.1, True)
    ops = backward_operands(q, k, v, kl, ref, ref_lse.float(), do)
    got = _launch_dq(*ops, d**-0.5, 0.1, True, n_split=n_split)
    dq, _, _ = flash_backward_reference(q, k, v, kl, ref, ref_lse.float(), do, d**-0.5, 0.1, True)
    assert got.dtype == dtype and worst(got, dq) <= 1
    if n_split > 1:
        cpu = [t.cpu() for t in (q, k, v, kl, ref, ref_lse.float(), do)]
        assert worst(got, split_dq_reference(*cpu, d**-0.5, 0.1, True, n_split).cuda()) <= 1


@pytest.mark.parametrize("cap", [1, 2, 3])
@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
def test_clustered_dq_passes_past_a_smaller_cluster(rn, max_cluster, tag, cap):
    """With the largest cluster cut to 1, 2 or 3 CTAs K5 at d 512 / 1,024
    takes passes (1: a pass per block of 256 columns, S and dP in each over
    the whole d) and agrees with the twin, at the default split and at 3."""
    max_cluster(cap)
    dtype, worst = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    for d in (512, 1024):
        b, H, KVH, L = 1, 4, 2, 150
        q, k, v, do = r(b, H, L, d), r(b, KVH, L, d), r(b, KVH, L, d), r(b, H, L, d)
        kl = torch.tensor([140], device="cuda", dtype=torch.int32)
        ref, ref_lse = flash_reference(q, k, v, kl, d**-0.5, 0.0, True)
        ops = backward_operands(q, k, v, kl, ref, ref_lse.float(), do)
        dq, _, _ = flash_backward_reference(q, k, v, kl, ref, ref_lse.float(), do, d**-0.5, 0.0, True)
        for n_split in (None, 3):
            assert worst(_launch_dq(*ops, d**-0.5, 0.0, True, n_split=n_split), dq) <= 1


@pytest.mark.parametrize("tag", sorted(WIDE_DTYPES))
def test_refused_dq_cluster_raises_in_the_wrapper(rn, max_cluster, tag):
    """K5 in one cluster of 16 CTAs (d 4,096 with the cap at 16, past the
    portable 8) is refused at launch and raises in the wrapper; at the
    default the same call launches in two passes of 8."""
    dtype, _ = WIDE_DTYPES[tag]
    r = _wide_rn(dtype)
    d = 4096
    q, k, v, do = r(1, 2, 64, d), r(1, 1, 64, d), r(1, 1, 64, d), r(1, 2, 64, d)
    out, lse = flash_forward(q, k, v, None, d**-0.5, 0.0, True)
    ops = backward_operands(q, k, v, None, out, lse, do)
    max_cluster(16)
    with pytest.raises(RuntimeError, match="hicom_flash_bwd_dq_wide"):
        _launch_dq(*ops, d**-0.5, 0.0, True)
    max_cluster(8)
    dq = _launch_dq(*ops, d**-0.5, 0.0, True)
    torch.cuda.synchronize()
    assert dq.isfinite().all()


@pytest.mark.parametrize("n_split", [None, 2, 5])
@pytest.mark.parametrize("d", [136, 192, 200, 256])
def test_warp_specialised_forward_192_256(rn, d, n_split):
    """The bf16 K1/K2 instances at padded 192 and 256 (d 136 and 200 on zero
    columns): K2 over 333 query rows (not a multiple of the 128-row block),
    7:1 grouped and causal with lengths 333 / 250 / 0 (a row with no key), at
    the default split and forced to 2 and 5 chunks against the split twin;
    the partials-only launch against the twin's partials; K1 over 3 x 300
    rows."""
    r = _wide_rn(torch.bfloat16)
    b, H, KVH, L = 3, 7, 1, 333
    q, k, v = r(b, H, L, d), r(b, KVH, L, d), r(b, KVH, L, d)
    kl = torch.tensor([333, 250, 0], device="cuda", dtype=torch.int32)
    out, lse = _launch(q, k, v, kl, d**-0.5, 0.1, True, n_split=n_split)
    ref, ref_lse = flash_reference(q, k, v, kl, d**-0.5, 0.1, True)
    assert out.dtype == torch.bfloat16 and _worst(out, ref) <= 1
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    if n_split is not None:
        cpu = [t.cpu() for t in (q, k, v, kl)]
        split, _ = split_forward_reference(*cpu, d**-0.5, 0.1, True, n_split)
        assert _worst(out, split.cuda()) <= 1
        o_part, m_part, l_part = _launch(q, k, v, kl, d**-0.5, 0.1, True, n_split=n_split, partials=True)
        merged, merged_lse = merge_partials_reference(o_part, m_part, l_part, torch.bfloat16)
        assert _worst(merged, ref) <= 1 and (merged_lse - ref_lse).abs().max().item() <= 1e-3
    merged, _ = merge_partials_reference(*flash_forward_partials(q, k, v, kl, d**-0.5, 0.1, True), torch.bfloat16)
    assert _worst(merged, ref) <= 1
    qf, kf, vf = r(3, 300, d), r(3, 300, d), r(3, 300, d)
    o1, lse1 = fullblock_attention(qf, kf, vf, d**-0.5, 0.1)
    ref1, ref1_lse = flash_reference(qf[:, None], kf[:, None], vf[:, None], None, d**-0.5, 0.1, False)
    assert _worst(o1, ref1[:, 0]) <= 1 and (lse1 - ref1_lse[:, 0]).abs().max().item() <= 1e-3
