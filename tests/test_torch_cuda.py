"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: they skip without a CUDA device (so on the CPU test runs).
On a machine with a card and no JAX, run them without the JAX-loading
conftest: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

bf16 inputs. Each output element may differ from the twin's by 2^-6 |ref| +
2^-5 rms(ref), the rule of ``chip_smoke.py``: two bf16 ulps of its own value
(both sides round the output; the kernel rounds or sums p at another running
max than the twin), plus a 32nd of the output's typical size for elements near
zero, whose error is that of the row's sum of rounded terms.
"""

import pytest
import torch

from hicom_tpu_torch.ops.flash_attention import (DKV_BLOCK_K, _launch, _launch_dkv, _launch_dq, _launch_merge,
                                                 _launch_part_sum, backward_operands, dkv_splits, flash_attention_gqa,
                                                 flash_backward, flash_backward_reference, flash_forward,
                                                 flash_reference, forward_splits, fullblock_attention,
                                                 merge_partials_reference, sum_partials_reference)
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
    q = rn(2, 4, 16, 72).float()  # fp32: the kernel takes bf16 only
    with pytest.raises(TypeError):
        flash_forward(q, q, q, None, 0.1, 0.0, False)


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
    assert 2 * 9 * forward_splits(2, 9, 32, 23328) >= 132 and 9 * forward_splits(1, 9, 32, 23328) >= 132


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
    assert -(-743 // DKV_BLOCK_K) * 2 * 4 * dkv_splits(2, 28, 4, 743, 743) >= 132


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
