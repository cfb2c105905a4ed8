"""The arithmetic and the grids of the wide forward, K5 and K6 (``csrc/flash_wide.cuh``), on the CPU.

Past head dim 256 the forward (K1/K2), K5 and K6 run as thread-block
clusters: the padded d's chunks of 64 columns are cut into one near-equal
share per CTA, each CTA computes a partial S (K5: S and dP; K6: S^T and
dP^T) over its share, and the cluster adds the partials in rank order. Their
fp32 instances multiply in 3xTF32 (each operand split into TF32 hi and lo
parts, lo hi + hi lo + hi hi in fp32 accumulators). Here:

* a test-local emulation of that arithmetic (TF32 rounding to nearest, ties
  away, by integer masking of the fp32 bits, as ``cvt.rna.tf32.f32`` rounds;
  each share's partial product exact in float64 and rounded to fp32, the
  partials added in fp32 in rank order) of the forward, of K5's dQ and of
  K6's dK and dV, held to the fp32 twins (``flash_reference``,
  ``flash_backward_reference``) within ``chip_smoke.FP32_GATE`` at d 288,
  512 and 1,024, causal with kv_lengths and GQA; one TF32 product (1xTF32)
  fails the same gate;
* the Python side of the grids: ``wide_cluster`` (CTAs a cluster and passes
  past the largest cluster), ``wide_column_blocks`` and the shares the
  kernels derive from them;
* ``forward_splits`` / ``dq_splits`` / ``dkv_splits`` at the wide shapes, and
  the split twins (``split_forward_reference``, ``split_dq_reference``,
  ``split_dkv_reference``), which walk the kernels' key tiles and units,
  against the unsplit twins at d 512; and the bf16 forward's 96-key tiles
  at the padded width 192 (``fwd_block_k``) in the split rule and twin.

No JAX and no card; one torch thread.
"""

import pytest
import torch

import chip_smoke
from hicom_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32(x):
    """fp32 values rounded to TF32 (10-bit mantissa), to nearest with ties
    away from zero: a half unit of the 13 dropped bits added to the
    magnitude's bits, then those bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, passes):
    """a @ b with TF32 operands: 3 passes (lo hi + hi lo + hi hi, lo = the
    TF32 rounding of x - hi) or 1 (hi hi), each product exact in float64,
    the sum rounded to fp32."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return (ah.double() @ bh.double()).float()
    al, bl = tf32(a.float() - ah), tf32(b.float() - bh)
    return (al.double() @ bh.double() + ah.double() @ bl.double() + ah.double() @ bh.double()).float()


def shares(d, kind):
    """Each cluster rank's columns of the contraction over d, as the kernels
    cut them: the padded d's chunks of 64 into C near-equal shares."""
    size, _ = tfa.wide_cluster(d, kind)
    ndc = tfa._padded(d) // 64
    return [slice(64 * (ndc * r // size), min(d, 64 * (ndc * (r + 1) // size))) for r in range(size)]


def contraction(a, b, d, kind, passes):
    """a @ b^T over the last axis, as a cluster forms it: each rank's share in
    TF32 products, the partials added in fp32 in rank order."""
    total = torch.zeros(a.shape[:-1] + b.shape[-2:-1], dtype=torch.float32)
    for cols in shares(d, kind):
        total = total + product(a[..., cols], b[..., cols].transpose(-1, -2), passes)
    return total


def grouped(x, KVH):
    b, H, L, d = x.shape
    return x.reshape(b, KVH, H // KVH, L, d)


def emulated_forward(q, k, v, lens, scale, bias, passes):
    """The wide forward's result in TF32 arithmetic (the fp32 twin's
    formulas: masked logits at -1e30, denominator at least 1e-30)."""
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    s = contraction(grouped(q, KVH), k[:, :, None], d, "fwd", passes) * scale + bias
    valid = tfa._valid(b, Lq, Lk, lens, True, q.device)
    s = torch.where(valid, s, torch.full_like(s, tfa.NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = product(p, v[:, :, None], passes)
    return (o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).reshape(b, H, Lq, d)


def emulated_dkv(q, k, v, lens, out, lse, do, scale, bias, passes):
    """K6's dK and dV in TF32 arithmetic from the forward's lse: P^T and dS^T
    from the cluster's S^T and dP^T, then dV = P^T dO and dK = scale dS^T Q
    summed over each kv head's group."""
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    qg, dog = grouped(q, KVH), grouped(do, KVH)
    st = contraction(k[:, :, None], qg, d, "dkv", passes)  # (b, KVH, g, Lk, Lq)
    dpt = contraction(v[:, :, None], dog, d, "dkv", passes)
    valid = tfa._valid(b, Lq, Lk, lens, True, q.device).transpose(-1, -2)
    lse_t = grouped(lse[..., None], KVH).transpose(-1, -2)
    delta_t = grouped((do * out).sum(dim=-1, keepdim=True), KVH).transpose(-1, -2)
    p = torch.where(valid, torch.exp(st * scale + bias - lse_t), torch.zeros_like(st))
    ds = p * (dpt - delta_t)
    dv = product(p, dog, passes).sum(dim=2)
    dk = scale * product(ds, qg, passes).sum(dim=2)
    return dk, dv


def emulated_dq(q, k, v, lens, out, lse, do, scale, bias, passes):
    """K5's dQ in TF32 arithmetic from the forward's lse: S and dP from the
    cluster's partials over the shares, added in rank order, then P, dS = P
    (dP - delta) and dQ = scale dS K."""
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    qg, dog = grouped(q, KVH), grouped(do, KVH)
    s = contraction(qg, k[:, :, None], d, "dq", passes)  # (b, KVH, g, Lq, Lk)
    dp = contraction(dog, v[:, :, None], d, "dq", passes)
    valid = tfa._valid(b, Lq, Lk, lens, True, q.device)
    delta = grouped((do * out).sum(dim=-1, keepdim=True), KVH)
    p = torch.where(valid, torch.exp(s * scale + bias - grouped(lse[..., None], KVH)), torch.zeros_like(s))
    dq = scale * product(p * (dp - delta), k[:, :, None], passes)
    return dq.reshape(b, H, Lq, d)


def draw(d, seed):
    """b 2, 4 query heads over 1 kv head, 96 tokens, lengths 96 / 70."""
    gen = torch.Generator().manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    q, k, v, do = rn(2, 4, 96, d), rn(2, 1, 96, d), rn(2, 1, 96, d), rn(2, 4, 96, d)
    return q, k, v, torch.tensor([96, 70]), do


@pytest.mark.parametrize("d", [288, 512, 1024])
def test_three_tf32_products_keep_the_fp32_gate(d):
    q, k, v, lens, do = draw(d, d)
    scale, bias = d**-0.5, 0.1
    ref, lse = tfa.flash_reference(q, k, v, lens, scale, bias, True)
    _, dk_ref, dv_ref = tfa.flash_backward_reference(q, k, v, lens, ref, lse, do, scale, bias, True)
    got = emulated_forward(q, k, v, lens, scale, bias, 3)
    dk, dv = emulated_dkv(q, k, v, lens, ref, lse, do, scale, bias, 3)
    for g, r in ((got, ref), (dk, dk_ref), (dv, dv_ref)):
        assert chip_smoke.agreement(g, r, chip_smoke.FP32_GATE)[1] <= 0.5


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("d", [288, 512, 1024])
def test_k5_clustered_dq_in_tf32_against_the_fp32_gate(d, passes):
    """K5's dQ with S and dP summed over the cluster's shares: within the
    fp32 gate in 3xTF32, past it four times over in one TF32 product."""
    q, k, v, lens, do = draw(d, d + 1)
    scale, bias = d**-0.5, 0.1
    ref, lse = tfa.flash_reference(q, k, v, lens, scale, bias, True)
    dq_ref, _, _ = tfa.flash_backward_reference(q, k, v, lens, ref, lse, do, scale, bias, True)
    ratio = chip_smoke.agreement(emulated_dq(q, k, v, lens, ref, lse, do, scale, bias, passes), dq_ref,
                                 chip_smoke.FP32_GATE)[1]
    assert ratio <= 0.5 if passes == 3 else ratio > 4


@pytest.mark.parametrize("d", [288, 512, 1024])
def test_one_tf32_product_fails_the_fp32_gate(d):
    q, k, v, lens, do = draw(d, d)
    scale, bias = d**-0.5, 0.1
    ref, lse = tfa.flash_reference(q, k, v, lens, scale, bias, True)
    _, dk_ref, dv_ref = tfa.flash_backward_reference(q, k, v, lens, ref, lse, do, scale, bias, True)
    got = emulated_forward(q, k, v, lens, scale, bias, 1)
    dk, dv = emulated_dkv(q, k, v, lens, ref, lse, do, scale, bias, 1)
    for g, r in ((got, ref), (dk, dk_ref), (dv, dv_ref)):
        assert chip_smoke.agreement(g, r, chip_smoke.FP32_GATE)[1] > 4


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0**-10  # a TF32 value: 10 mantissa bits
    x = torch.tensor([one + 2.0**-11, -(one + 2.0**-11), 1.0 + 2.0**-11 - 2.0**-20, 3.0, one])
    assert tf32(x).tolist() == [one + 2.0**-10, -(one + 2.0**-10), 1.0, 3.0, one]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32(y)
    assert ((y - hi).abs() <= hi.abs() * 2.0**-11).all()
    assert ((y - hi - tf32(y - hi)).abs() <= y.abs() * 2.0**-21).all()


@pytest.mark.parametrize("d,fwd,dkv", [
    (264, (2, 1), (3, 1)), (288, (2, 1), (3, 1)), (320, (2, 1), (3, 1)), (512, (2, 1), (4, 1)),
    (1024, (4, 1), (8, 1)),  # K6's largest portable cluster exactly
    (1032, (5, 1), (5, 2)), (1088, (5, 1), (5, 2)),  # just past it: two passes of 5 CTAs (10 blocks for 9)
    (2048, (8, 1), (8, 2)), (2112, (5, 2), (6, 3)),
])
def test_wide_clusters_and_passes(d, fwd, dkv):
    assert tfa.wide_cluster(d, "fwd") == fwd and tfa.wide_cluster(d, "dkv") == dkv
    assert tfa.wide_column_blocks(d, "fwd") == fwd[0] * fwd[1]
    assert tfa.wide_column_blocks(d, "dkv") == dkv[0] * dkv[1]
    assert tfa.wide_cluster(d, "dq") == fwd  # K5's output blocks are the forward's 256 columns
    assert tfa.wide_column_blocks(d, "dq") == fwd[0] * fwd[1]


def test_wide_grids_up_to_256_hold_whole_rows():
    assert [tfa.wide_column_blocks(d, kind) for d in (64, 256) for kind in ("fwd", "dq", "dkv")] == [1] * 6


def test_passes_past_the_largest_cluster(monkeypatch):
    monkeypatch.setattr(tfa, "WIDE_MAX_CLUSTER", 1)  # one CTA a cluster: a pass per block (the first design)
    assert tfa.wide_cluster(512, "dkv") == (1, 4) and tfa.wide_cluster(1024, "fwd") == (1, 4)
    monkeypatch.setattr(tfa, "WIDE_MAX_CLUSTER", 16)  # a non-portable size: K6 at d 2,048 in one pass
    assert tfa.wide_cluster(2048, "dkv") == (16, 1) and tfa.wide_cluster(4096, "dkv") == (16, 2)


@pytest.mark.parametrize("kind,columns", [("fwd", 256), ("dkv", 128), ("dq", 256)])
def test_every_width_balances_its_blocks_and_shares(kind, columns):
    """At every d % 8 == 0 from 264 to 4,096: at most 8 CTAs a cluster, every
    output block at most ``columns`` wide and at least one chunk, blocks and
    shares within one chunk of each other, and one pass wherever the blocks
    fit one cluster (then a share is its CTA's own output block)."""
    for d in range(264, 4097, 8):
        size, passes = tfa.wide_cluster(d, kind)
        ndc = tfa._padded(d) // 64
        blocks = [ndc * (j + 1) // (size * passes) - ndc * j // (size * passes) for j in range(size * passes)]
        share = [ndc * (r + 1) // size - ndc * r // size for r in range(size)]
        assert 1 <= size <= 8 and sum(blocks) == sum(share) == ndc
        assert 1 <= min(blocks) and max(blocks) * 64 <= columns and max(blocks) - min(blocks) <= 1
        assert max(share) - min(share) <= 1
        assert (passes == 1) == (-(-tfa._padded(d) // columns) <= 8)


def test_split_rules_count_the_clustered_grids():
    # [hd512]'s prefill (b 2, 7 / 1 heads of 512, 743 tokens): 12 x 14 x 2 forward CTAs fill the card; K6's
    # 12 x 2 x 4 do not, so its units split in 3
    assert tfa.forward_splits(2, 7, 743, 743, d=512) == 1
    assert tfa.dkv_splits(2, 7, 1, 743, 743, d=512) == 3
    # the 4 / 1 heads of 1,024: 8 K6 CTAs a key block fill the card; 32 queries at d 512 split the keys
    assert tfa.dkv_splits(2, 4, 1, 743, 743, d=1024) == 1
    assert tfa.forward_splits(1, 4, 32, 3000, d=512) == 33
    # past a cluster the passes add CTAs on z: K6 at d 1,088 has 10 CTAs per block of 64 keys (100 here)
    assert tfa.dkv_splits(1, 1, 1, 640, 640, d=1088) == 3


@pytest.mark.parametrize("n_split", [2, 3, 7])
def test_split_twins_describe_the_wide_kernels(n_split):
    """The split paths walk the same key tiles and units whatever the
    columns: at d 512, causal GQA with lengths, the split twins equal the
    unsplit ones at the fp32 gate."""
    q, k, v, lens, do = draw(512, 7)
    scale = 512**-0.5
    ref, lse = tfa.flash_reference(q, k, v, lens, scale, 0.0, True)
    split, split_lse = tfa.split_forward_reference(q, k, v, lens, scale, 0.0, True, n_split)
    assert chip_smoke.agreement(split, ref, chip_smoke.FP32_GATE)[1] <= 1
    assert (split_lse - lse).abs().max().item() <= 1e-5
    _, dk_ref, dv_ref = tfa.flash_backward_reference(q, k, v, lens, ref, lse, do, scale, 0.0, True)
    dk, dv = tfa.split_dkv_reference(q, k, v, lens, ref, lse, do, scale, 0.0, True, n_split)
    assert chip_smoke.agreement(dk, dk_ref, chip_smoke.FP32_GATE)[1] <= 1
    assert chip_smoke.agreement(dv, dv_ref, chip_smoke.FP32_GATE)[1] <= 1


def test_dq_splits_count_the_clustered_grid():
    """K5's key splits count its clusters' CTAs and passes at every d % 8 ==
    0 from 264 to 4,096: one split where the grid fills the card, else about
    two CTAs an SM and never more splits than key tiles; z within the
    grid's limit."""
    for d in range(264, 4097, 8):
        size, passes = tfa.wide_cluster(d, "dq")
        ctas = size * passes
        assert tfa.wide_column_blocks(d, "dq") == ctas
        for b, H, lq, lk in ((2, 7, 743, 743), (1, 4, 32, 3000), (2, 1, 64, 64)):
            n = tfa.dq_splits(b, H, lq, lk, d=d)
            blocks = -(-lq // tfa.WIDE_BLOCK_Q) * b * H * ctas
            assert n == (1 if blocks >= tfa.H100_SMS else max(1, min(-(-lk // tfa.DQ_BLOCK_K),
                                                                     2 * tfa.H100_SMS // blocks)))
            assert 1 <= n <= -(-lk // tfa.DQ_BLOCK_K) and n * ctas <= 65535
    # [hd512]'s prefill: 12 x 14 x 2 CTAs fill the card; 32 queries of 4 heads at d 512 (two CTAs a cluster)
    assert tfa.dq_splits(2, 7, 743, 743, d=512) == 1 and tfa.dq_splits(1, 4, 32, 3000, d=512) == 33
    # d 2,112: 33 chunks in two passes of 5 CTAs (10 blocks of at most 4 chunks)
    assert tfa.wide_cluster(2112, "dq") == (5, 2) and tfa.dq_splits(1, 1, 64, 640, d=2112) == 20


@pytest.mark.parametrize("n_split", [2, 3, 7])
def test_split_dq_twin_describes_the_wide_k5(n_split):
    """K5's split path walks the same 32-key tiles from 64-row blocks
    whatever its clusters: at d 512, causal GQA with lengths, the split twin
    equals the unsplit one at the fp32 gate."""
    q, k, v, lens, do = draw(512, 11)
    scale = 512**-0.5
    ref, lse = tfa.flash_reference(q, k, v, lens, scale, 0.1, True)
    dq_ref, _, _ = tfa.flash_backward_reference(q, k, v, lens, ref, lse, do, scale, 0.1, True)
    dq = tfa.split_dq_reference(q, k, v, lens, ref, lse, do, scale, 0.1, True, n_split)
    assert chip_smoke.agreement(dq, dq_ref, chip_smoke.FP32_GATE)[1] <= 1


def test_forward_tiles_at_192_follow_the_bf16_kernel():
    """bf16 at the padded width 192 (d 136-192) walks 96-key tiles, every
    other width and fp32 64: the split rule caps its chunks at those tiles,
    and the split twin cuts its chunks on them (``tile_range`` over 96-key
    tiles; at d 192 and 136, causal GQA with lengths, 2 / 3 / 7 chunks equal
    to the unsplit twin at the bf16 gate)."""
    bf16 = torch.bfloat16
    assert [tfa.fwd_block_k(d, bf16) for d in (128, 136, 192, 200, 256, 512)] == [64, 96, 96, 64, 64, 64]
    assert tfa.fwd_block_k(192, torch.float32) == 64
    # 32 queries of one head over 3,000 keys: one 128-row block, capped at the 32 (bf16) or 47 (fp32) tiles
    assert tfa.forward_splits(1, 1, 32, 3000, d=192) == 32
    assert tfa.forward_splits(1, 1, 32, 3000, d=192, dtype=torch.float32) == 47
    assert tfa.tile_range(0, 128, 300, 300, 300, False, 96, 1, 2, True) == (2, 4)  # chunk 1 of 2: keys 192-299
    gen = torch.Generator().manual_seed(3)
    for d in (192, 136):
        q, k, v = (torch.randn(2, 4, 200, d, generator=gen).to(bf16) for _ in range(3))
        lens = torch.tensor([200, 130])
        ref, lse = tfa.flash_reference(q, k[:, :1], v[:, :1], lens, d**-0.5, 0.0, True)
        for n_split in (2, 3, 7):
            out, out_lse = tfa.split_forward_reference(q, k[:, :1], v[:, :1], lens, d**-0.5, 0.0, True, n_split)
            assert chip_smoke.agreement(out.float(), ref.float(), chip_smoke.BF16_GATE)[1] <= 1
            assert (out_lse - lse).abs().max().item() <= 1e-4
