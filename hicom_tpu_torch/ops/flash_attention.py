"""Flash attention: the Hopper kernels of ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, their
plain twins, and the ``torch.autograd.Function`` that joins them.

Two CUDA sources take the place of four Pallas TPU kernels of
``hicom_tpu/ops/flash_attention.py``:

* :func:`fullblock_attention` replaces ``_fullblock_kernel`` (K1): unmasked
  attention with every row seeing the whole kv, the SigLIP tower shape;
* :func:`flash_forward` replaces ``_flash_kernel`` (K2): causal (aligned
  bottom-right) and ``kv_lengths`` masks, and grouped-query attention with the
  kv head indexed as ``h // g`` instead of folded rows;
* :func:`flash_backward` replaces ``_bwd_dq_kernel`` (K5) and
  ``_bwd_dkv_kernel`` (K6): dQ, and dK/dV summed over each kv head's group of
  query heads, with P recomputed from the forward's lse.

The forwards return ``(out, lse)``. Each wrapper runs the plain PyTorch twin
for CPU tensors and launches its kernels for CUDA tensors, or raises;
``launches`` counts wrapper calls that launched kernels (a split launch and
its merge or sum pass count once).

When a grid of one block per query tile cannot fill the card (the global
compressor's 32 queries), the forward and K5 split the key axis into chunks
(:func:`forward_splits`, :func:`dq_splits`): each block writes its chunk's
fp32 partial to a workspace, and a second kernel merges the forward's
partials by their maxima (:func:`merge_partials_reference` is its plain
version) or sums K5's (:func:`sum_partials_reference`), in a fixed order.
K6 has one block per 64 keys of a kv head; when those cannot fill the card
(the decoder's 96) it splits each block's walk over its (query head, query
tile) units (:func:`dkv_splits`, :func:`dkv_unit_range`) and sums the fp32
dK and dV partials the same way. :func:`split_forward_reference`,
:func:`split_dq_reference` and :func:`split_dkv_reference` are the split
paths in plain PyTorch, over the kernels' own tiles.

:class:`FlashAttention` is the counterpart of JAX's ``_flash_bhld``
``custom_vjp``: its forward runs K1 or K2 and saves (q, k, v, kv_lengths, out,
lse), its backward runs :func:`flash_backward`. :func:`run_kernel`,
:func:`flash_attention` and :func:`flash_attention_gqa` (so ``sdpa`` too) go
through it whenever a gradient is wanted, and straight to the forward kernel
otherwise (serving under ``torch.inference_mode()`` saves nothing).
:func:`uses_fullblock` is the one rule that chooses between K1 and K2, as
``_flash_fwd_impl`` chooses on the TPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .cuda_build import c_function, check

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 256
NEG_INF = -1e30
FWD_BLOCK_Q, FWD_BLOCK_K = 128, 64  # the forward kernel's query rows per block, keys per tile
DQ_BLOCK_K = 32  # K5's keys per tile
DKV_BLOCK_K, DKV_BLOCK_Q = 64, 64  # K6's keys per block, query rows per unit
H100_SMS = 132

Tensor = torch.Tensor


def _acc_dtype(x: Tensor) -> torch.dtype:
    """The twins' working type: float64 for float64 inputs (gradcheck), else float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _valid(b: int, Lq: int, Lk: int, kv_lengths: Optional[Tensor], causal: bool, device) -> Tensor:
    """(b, 1, 1, Lq, Lk) bool: keys below the row's kv length and, if causal,
    at most ``q + Lk - Lq`` (the diagonal aligned bottom-right)."""
    k_pos = torch.arange(Lk, device=device)
    valid = torch.ones((b, 1, 1, Lq, Lk), dtype=torch.bool, device=device)
    if kv_lengths is not None:
        valid = valid & (k_pos[None, :] < kv_lengths.to(device)[:, None]).reshape(b, 1, 1, 1, Lk)
    if causal:
        q_pos = torch.arange(Lq, device=device)
        valid = valid & (k_pos[None, :] <= q_pos[:, None] + (Lk - Lq))
    return valid


def flash_reference(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], scale: float,
                    logit_bias: float, causal: bool) -> Tuple[Tensor, Tensor]:
    """Plain twin of the forward kernel: q (b, H, Lq, d), k/v (b, KVH, Lk, d), kv_lengths (b,).

    fp32 logits (fp64 for fp64 inputs), masked entries at -1e30 (the TPU
    kernel's convention), causal mask aligned bottom-right, p rounded to v's
    dtype before the weighted sum, denominator ``max(l, 1e-30)``. Returns out
    (q.dtype) and lse (b, H, Lq) in the working type.
    """
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    acc = _acc_dtype(q)
    qg = q.reshape(b, KVH, H // KVH, Lq, d).to(acc)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(acc)) * scale + logit_bias
    valid = _valid(b, Lq, Lk, kv_lengths, causal, q.device)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype).to(acc), v.to(acc)) / denom
    lse = (m + torch.log(denom))[..., 0]
    return out.reshape(b, H, Lq, d).to(q.dtype), lse.reshape(b, H, Lq)


def flash_backward_reference(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], out: Tensor,
                             lse: Tensor, do: Tensor, scale: float, logit_bias: float, causal: bool
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain twin of K5 + K6, written out from the formulas of
    ``_bwd_dq_kernel``/``_bwd_dkv_kernel``: p = exp(s - lse) where unmasked, else
    0; delta = rowsum(dO * O); dS = p (dP - delta); dQ = scale dS K, dK = scale
    dSᵀ Q (summed over each group's query heads), dV = pᵀ dO. p is rounded to
    dO's dtype before dV, dS to K's/Q's dtype before dQ/dK, and every sum is in
    the working type. Query rows past ``kv_lengths`` are not masked. Returns
    (dq, dk, dv) in the dtypes of q, k and v."""
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    g = H // KVH
    acc = _acc_dtype(q)
    grouped = lambda x: x.reshape(b, KVH, g, Lq, x.shape[-1]).to(acc)  # noqa: E731
    qg, dog = grouped(q), grouped(do)
    kf, vf = k.to(acc), v.to(acc)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale + logit_bias
    valid = _valid(b, Lq, Lk, kv_lengths, causal, q.device)
    p = torch.where(valid, torch.exp(s - lse.reshape(b, KVH, g, Lq, 1).to(acc)), torch.zeros_like(s))
    delta = (dog * grouped(out)).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dog, vf) - delta)
    dq = scale * torch.einsum("bkgqs,bksd->bkgqd", ds.to(k.dtype).to(acc), kf)
    dk = scale * torch.einsum("bkgqs,bkgqd->bksd", ds.to(q.dtype).to(acc), qg)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p.to(do.dtype).to(acc), dog)
    return dq.reshape(b, H, Lq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dq_block_q(lq: int) -> int:
    """K5's query rows per block: 32 (two warps) for at most 32 queries, else 64."""
    return 32 if lq <= 32 else 64


def _splits(blocks: int, units: int, sms: int) -> int:
    """One chunk when ``blocks`` fill the card, else about two blocks per SM,
    never more chunks than a block has ``units`` (key tiles, or K6's units)."""
    if blocks >= sms:
        return 1
    return max(1, min(units, 2 * sms // blocks))


def forward_splits(b: int, H: int, lq: int, lk: int, sms: int = H100_SMS) -> int:
    """Chunks of the key axis for the forward kernel (K1/K2): 1 at the tower
    and prefill shapes, 29 at the global compressor's b 1 and 14 at b 2."""
    return _splits(-(-lq // FWD_BLOCK_Q) * b * H, -(-lk // FWD_BLOCK_K), sms)


def dq_splits(b: int, H: int, lq: int, lk: int, sms: int = H100_SMS) -> int:
    """Chunks of the key axis for K5: 1 at the tower and prefill shapes, 14
    at the global compressor's b 2 (252 blocks of 32 query rows)."""
    return _splits(-(-lq // dq_block_q(lq)) * b * H, -(-lk // DQ_BLOCK_K), sms)


def dkv_splits(b: int, H: int, KVH: int, lq: int, lk: int, sms: int = H100_SMS) -> int:
    """Ranges of each K6 block's units: one where the blocks of 64 keys fill
    the card (the global compressor, the tower), else at least two blocks per
    SM, rounded up because a causal mask leaves the blocks uneven (the first
    key tile is seen by every query tile, the last by one): 3 at the decoder
    prefill's b 2, whose 96 blocks become 288, never more than a block's units."""
    blocks = -(-lk // DKV_BLOCK_K) * b * KVH
    if blocks >= sms:
        return 1
    return max(1, min(H // KVH * -(-lq // DKV_BLOCK_Q), -(-2 * sms // blocks)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_range(q0: int, block_q: int, lq: int, lk: int, kv_limit: int, causal: bool, block_k: int, split: int,
               n_split: int, walk_empty: bool) -> Tuple[int, int]:
    """The key tiles [begin, end) that chunk ``split`` of the query block at
    row ``q0`` walks, as the kernels compute it: the tiles below ``kv_limit``
    and (causal) up to the block's last diagonal, cut into ``n_split`` near-
    equal chunks. With ``walk_empty`` (the forward) a block holding a row
    with no valid key walks every tile."""
    n = max(0, -(-kv_limit // block_k))
    if causal:
        max_key = min(q0 + block_q - 1, lq - 1) + lk - lq
        n = 0 if max_key < 0 else min(n, max_key // block_k + 1)
    if walk_empty and (kv_limit == 0 or (causal and q0 + lk - lq < 0)):
        n = -(-lk // block_k)
    return n * split // n_split, n * (split + 1) // n_split


def dkv_unit_range(k0: int, lq: int, lk: int, kv_limit: int, causal: bool, g: int, split: int, n_split: int
                   ) -> Tuple[int, int, int, int]:
    """K6's walk, as the kernel computes it, for the block of keys from
    ``k0``: its units are (query head of the group, 64-row query tile) pairs,
    head-major, over the tiles that can see the keys (none for keys wholly
    past ``kv_limit``). Returns (first query tile, tiles per head, and the
    units [begin, end) of chunk ``split`` of ``n_split``)."""
    qt_begin = max(0, k0 - (lk - lq)) // DKV_BLOCK_Q if causal else 0
    nq = max(0, -(-lq // DKV_BLOCK_Q) - qt_begin) if k0 < kv_limit else 0
    return qt_begin, nq, g * nq * split // n_split, g * nq * (split + 1) // n_split


def _limits(b: int, lk: int, kv_lengths: Optional[Tensor]):
    lens = kv_lengths.tolist() if kv_lengths is not None else [lk] * b
    return [max(0, min(lk, int(n))) for n in lens]


def _chunk_valid(rows: slice, keys: slice, limit: int, causal: bool, lq: int, lk: int, device) -> Tensor:
    """(rows, keys) bool: keys below ``limit`` and, if causal, at most ``q + lk - lq``."""
    k_pos = torch.arange(keys.start, keys.stop, device=device)[None, :]
    valid = k_pos < limit
    if causal:
        valid = valid & (k_pos <= torch.arange(rows.start, rows.stop, device=device)[:, None] + (lk - lq))
    return valid


def merge_partials_reference(o_part: Tensor, m_part: Tensor, l_part: Tensor, dtype: torch.dtype
                             ) -> Tuple[Tensor, Tensor]:
    """Plain twin of the forward's merge kernel: o_part (n, ..., d), m_part and
    l_part (n, ...). Chunk s weighs exp(m_s - M), M the largest chunk max (0
    for a chunk with max -inf, which walked no tile); out = sum w o / max(sum
    w l, 1e-30) in ``dtype``, lse = M + log of that denominator."""
    M = m_part.amax(dim=0)
    w = torch.where(m_part == float("-inf"), torch.zeros_like(m_part), torch.exp(m_part - M))
    denom = (w * l_part).sum(dim=0).clamp_min(1e-30)
    out = (w[..., None] * o_part).sum(dim=0) / denom[..., None]
    return out.to(dtype), M + torch.log(denom)


def split_forward_reference(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], scale: float,
                            logit_bias: float, causal: bool, n_split: int) -> Tuple[Tensor, Tensor]:
    """The forward's split path in plain PyTorch: for every query block of
    128 rows, batch row and chunk, the partial (unnormalised output, max,
    denominator) over that chunk's 64-key tiles (:func:`tile_range`), masked
    logits at -1e30 and p rounded to v's dtype as the kernel does; then
    :func:`merge_partials_reference`. Shapes and result as :func:`flash_reference`."""
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    acc = _acc_dtype(q)
    o_part = torch.zeros((n_split, b, H, Lq, d), dtype=acc)
    m_part = torch.full((n_split, b, H, Lq), float("-inf"), dtype=acc)
    l_part = torch.zeros((n_split, b, H, Lq), dtype=acc)
    for bi, limit in enumerate(_limits(b, Lk, kv_lengths)):
        for q0 in range(0, Lq, FWD_BLOCK_Q):
            rows = slice(q0, min(q0 + FWD_BLOCK_Q, Lq))
            qs = q[bi, :, rows].reshape(KVH, H // KVH, -1, d).to(acc)
            for s in range(n_split):
                t0, t1 = tile_range(q0, FWD_BLOCK_Q, Lq, Lk, limit, causal, FWD_BLOCK_K, s, n_split, True)
                if t0 >= t1:
                    continue
                keys = slice(t0 * FWD_BLOCK_K, min(t1 * FWD_BLOCK_K, Lk))
                logits = torch.einsum("kgqd,ksd->kgqs", qs, k[bi, :, keys].to(acc)) * scale + logit_bias
                valid = _chunk_valid(rows, keys, limit, causal, Lq, Lk, q.device)
                logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
                m = logits.amax(dim=-1, keepdim=True)
                p = torch.exp(logits - m)
                o = torch.einsum("kgqs,ksd->kgqd", p.to(v.dtype).to(acc), v[bi, :, keys].to(acc))
                o_part[s, bi, :, rows] = o.reshape(H, -1, d)
                m_part[s, bi, :, rows] = m[..., 0].reshape(H, -1)
                l_part[s, bi, :, rows] = p.sum(dim=-1).reshape(H, -1)
    return merge_partials_reference(o_part, m_part, l_part, q.dtype)


def sum_partials_reference(part: Tensor, scale: float, dtype: torch.dtype) -> Tensor:
    """Plain twin of the split path's sum pass (K5's dQ, K6's dK and dV):
    ``scale`` times the sum of the chunks' fp32 partials (n, ...), in ``dtype``."""
    return (part.sum(dim=0) * scale).to(dtype)


def split_dq_reference(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], out: Tensor, lse: Tensor,
                       do: Tensor, scale: float, logit_bias: float, causal: bool, n_split: int) -> Tensor:
    """K5's split path in plain PyTorch: for every query block
    (:func:`dq_block_q` rows), batch row and chunk of 32-key tiles, the
    unscaled dQ partial sum of dS K with dS rounded to K's dtype, as
    :func:`flash_backward_reference` forms it; then
    :func:`sum_partials_reference`. Returns dq like q."""
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    acc = _acc_dtype(q)
    bq = dq_block_q(Lq)
    parts = torch.zeros((n_split, b, H, Lq, d), dtype=acc)
    delta = (do.to(acc) * out.to(acc)).sum(dim=-1)
    for bi, limit in enumerate(_limits(b, Lk, kv_lengths)):
        for q0 in range(0, Lq, bq):
            rows = slice(q0, min(q0 + bq, Lq))
            grouped = lambda x: x[bi, :, rows].reshape(KVH, H // KVH, -1, x.shape[-1]).to(acc)  # noqa: E731
            qs, dos = grouped(q), grouped(do)
            row_lse = lse[bi, :, rows].reshape(KVH, H // KVH, -1, 1).to(acc)
            row_delta = delta[bi, :, rows].reshape(KVH, H // KVH, -1, 1)
            for s in range(n_split):
                t0, t1 = tile_range(q0, bq, Lq, Lk, limit, causal, DQ_BLOCK_K, s, n_split, False)
                if t0 >= t1:
                    continue
                keys = slice(t0 * DQ_BLOCK_K, min(t1 * DQ_BLOCK_K, Lk))
                kf, vf = k[bi, :, keys].to(acc), v[bi, :, keys].to(acc)
                sc = torch.einsum("kgqd,ksd->kgqs", qs, kf) * scale + logit_bias
                valid = _chunk_valid(rows, keys, limit, causal, Lq, Lk, q.device)
                p = torch.where(valid, torch.exp(sc - row_lse), torch.zeros_like(sc))
                ds = p * (torch.einsum("kgqd,ksd->kgqs", dos, vf) - row_delta)
                parts[s, bi, :, rows] = torch.einsum("kgqs,ksd->kgqd", ds.to(k.dtype).to(acc), kf).reshape(H, -1, d)
    return sum_partials_reference(parts, scale, q.dtype)


def split_dkv_reference(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], out: Tensor, lse: Tensor,
                        do: Tensor, scale: float, logit_bias: float, causal: bool, n_split: int
                        ) -> Tuple[Tensor, Tensor]:
    """K6's split path in plain PyTorch: for every block of 64 keys, batch row
    and chunk, the unscaled dK and the dV partial sums over that chunk's
    units (:func:`dkv_unit_range`) in the kernel's order, with P and dS
    rounded as :func:`flash_backward_reference` rounds them; then the chunks
    summed in order by :func:`sum_partials_reference`, ``scale`` on dK.
    Returns (dk, dv) like k and v."""
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    g = H // KVH
    acc = _acc_dtype(q)
    dk_part = torch.zeros((n_split, b, KVH, Lk, d), dtype=acc)
    dv_part = torch.zeros((n_split, b, KVH, Lk, d), dtype=acc)
    delta = (do.to(acc) * out.to(acc)).sum(dim=-1)
    grouped = lambda x, bi: x[bi].reshape(KVH, g, Lq, x.shape[-1]).to(acc)  # noqa: E731
    for bi, limit in enumerate(_limits(b, Lk, kv_lengths)):
        qs, dos = grouped(q, bi), grouped(do, bi)
        row_lse, row_delta = lse[bi].reshape(KVH, g, Lq).to(acc), delta[bi].reshape(KVH, g, Lq)
        for k0 in range(0, Lk, DKV_BLOCK_K):
            keys = slice(k0, min(k0 + DKV_BLOCK_K, Lk))
            kf, vf = k[bi, :, keys].to(acc), v[bi, :, keys].to(acc)
            for s in range(n_split):
                qt_begin, nq, u0, u1 = dkv_unit_range(k0, Lq, Lk, limit, causal, g, s, n_split)
                for u in range(u0, u1):
                    hh, q0 = u // nq, (qt_begin + u % nq) * DKV_BLOCK_Q
                    rows = slice(q0, min(q0 + DKV_BLOCK_Q, Lq))
                    qu, dou = qs[:, hh, rows], dos[:, hh, rows]
                    sc = torch.einsum("krd,ksd->krs", qu, kf) * scale + logit_bias
                    valid = _chunk_valid(rows, keys, limit, causal, Lq, Lk, q.device)
                    p = torch.where(valid, torch.exp(sc - row_lse[:, hh, rows, None]), torch.zeros_like(sc))
                    ds = p * (torch.einsum("krd,ksd->krs", dou, vf) - row_delta[:, hh, rows, None])
                    dk_part[s, bi, :, keys] += torch.einsum("krs,krd->ksd", ds.to(q.dtype).to(acc), qu)
                    dv_part[s, bi, :, keys] += torch.einsum("krs,krd->ksd", p.to(do.dtype).to(acc), dou)
    return sum_partials_reference(dk_part, scale, k.dtype), sum_partials_reference(dv_part, 1.0, v.dtype)


def _check(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], what: str):
    """The kernels' common contract; returns (b, H, KVH, Lq, Lk, d, int32 lengths or None)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{what} takes q (b,H,Lq,d), k/v (b,KVH,Lk,d); got {q.shape}, {k.shape}, {v.shape}")
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or H % KVH:
        raise ValueError(f"{what}: incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{what} takes bfloat16 q, k and v")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError(f"{what}: q, k and v must be on one device")
    if d % 8 or d > 128 or (d + 15) // 16 * 16 not in (32, 64, 80, 128):
        raise ValueError(f"{what}: head dim {d} not supported")
    lens = None
    if kv_lengths is not None:
        lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (b,):
            raise ValueError(f"kv_lengths must be ({b},), got {tuple(lens.shape)}")
    return b, H, KVH, Lq, Lk, d, lens


def _launch(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], scale: float,
            logit_bias: float, causal: bool, n_split: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """The forward kernel (and its merge pass when split) on CUDA tensors.
    ``n_split`` defaults to :func:`forward_splits`; tests force it."""
    b, H, KVH, Lq, Lk, d, lens = _check(q, k, v, kv_lengths, "flash kernel")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if n_split is None:
        n_split = forward_splits(b, H, Lq, Lk, _sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    lse = torch.empty((b, H, Lq), dtype=torch.float32, device=q.device)
    parts = (None, None, None)
    if n_split > 1:
        parts = (torch.empty((n_split, b * H, Lq, d), dtype=torch.float32, device=q.device),
                 torch.empty((n_split, b * H, Lq), dtype=torch.float32, device=q.device),
                 torch.empty((n_split, b * H, Lq), dtype=torch.float32, device=q.device))
    fn = c_function("flash_fwd", "hicom_flash_fwd", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                    + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr() if lens is not None else None,
                out.data_ptr(), lse.data_ptr(), *(t.data_ptr() if t is not None else None for t in parts),
                b, H, KVH, Lq, Lk, d, int(n_split), float(scale), float(logit_bias), int(causal),
                torch.cuda.current_stream(q.device).cuda_stream)
    check(status, "hicom_flash_fwd")
    return out, lse


def _launch_merge(o_part: Tensor, m_part: Tensor, l_part: Tensor) -> Tuple[Tensor, Tensor]:
    """The forward's merge kernel alone on fp32 CUDA partials o_part (n, rows,
    d), m_part and l_part (n, rows): returns (out (rows, d) bf16, lse (rows,))."""
    n, rows, d = o_part.shape
    if m_part.shape != (n, rows) or l_part.shape != (n, rows) or d % 4:
        raise ValueError(f"merge takes o_part (n, rows, d % 4 == 0) and m/l (n, rows); got {tuple(o_part.shape)}")
    o_part, m_part, l_part = (t.float().contiguous() for t in (o_part, m_part, l_part))
    out = torch.empty((rows, d), dtype=torch.bfloat16, device=o_part.device)
    lse = torch.empty((rows,), dtype=torch.float32, device=o_part.device)
    fn = c_function("flash_fwd", "hicom_flash_merge", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    check(fn(o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), out.data_ptr(), lse.data_ptr(), n, rows, d,
             torch.cuda.current_stream(o_part.device).cuda_stream), "hicom_flash_merge")
    return out, lse


def fullblock_attention(q: Tensor, k: Tensor, v: Tensor, scale: float, logit_bias: float = 0.0
                        ) -> Tuple[Tensor, Tensor]:
    """K1: unmasked attention over (bh, L, d) rows (``_fullblock_fwd``)."""
    if q.device.type == "cpu":
        out, lse = flash_reference(q[:, None], k[:, None], v[:, None], None, scale, logit_bias, False)
        return out[:, 0], lse[:, 0]
    out, lse = _launch(q[:, None], k[:, None], v[:, None], None, scale, logit_bias, False)
    fullblock_attention.launches += 1
    return out[:, 0], lse[:, 0]


fullblock_attention.launches = 0


def flash_forward(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], scale: float,
                  logit_bias: float = 0.0, causal: bool = False) -> Tuple[Tensor, Tensor]:
    """K2: masked / grouped attention, q (b, H, Lq, d), k/v (b, KVH, Lk, d)."""
    if q.device.type == "cpu":
        return flash_reference(q, k, v, kv_lengths, scale, logit_bias, causal)
    out = _launch(q, k, v, kv_lengths, scale, logit_bias, causal)
    flash_forward.launches += 1
    return out


flash_forward.launches = 0


_BWD_ARGS = [ctypes.c_void_p] * 7


def _bwd_args(q, k, v, lens, do, lse, delta, scale, logit_bias, causal):
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr() if lens is not None else None,
             do.data_ptr(), lse.data_ptr(), delta.data_ptr()),
            (b, H, KVH, Lq, Lk, d, float(scale), float(logit_bias), int(causal),
             torch.cuda.current_stream(q.device).cuda_stream))


def _launch_dq(q, k, v, lens, do, lse, delta, scale, logit_bias, causal, n_split: Optional[int] = None) -> Tensor:
    """K5 (and its sum pass when split) on checked, contiguous CUDA tensors
    (no launch count: see :func:`flash_backward`). ``n_split`` defaults to
    :func:`dq_splits`; tests force it."""
    b, H, Lq, d = q.shape
    if n_split is None:
        n_split = dq_splits(b, H, Lq, k.shape[2], _sm_count(q.device.index or 0))
    dq = torch.empty_like(q)
    part = torch.empty((n_split, b * H, Lq, d), dtype=torch.float32, device=q.device) if n_split > 1 else None
    head, tail = _bwd_args(q, k, v, lens, do, lse, delta, scale, logit_bias, causal)
    fn = c_function("flash_bwd", "hicom_flash_bwd_dq", _BWD_ARGS + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                    + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    check(fn(*head, dq.data_ptr(), part.data_ptr() if part is not None else None, *tail[:6], int(n_split), *tail[6:]),
          "hicom_flash_bwd_dq")
    return dq


def _launch_part_sum(*pairs: Tuple[Tensor, float]) -> Tuple[Tensor, ...]:
    """The split path's sum pass alone on one or two (fp32 CUDA workspace (n,
    ...), scale) pairs of one shape (K5's dQ; K6's dK and dV): ``scale`` times
    the sum over n, in bf16, one launch for all."""
    parts = [p.float().contiguous() for p, _ in pairs]
    if len(parts) not in (1, 2) or any(p.shape != parts[0].shape for p in parts):
        raise ValueError("the sum pass takes one or two workspaces of one shape")
    outs = [torch.empty(p.shape[1:], dtype=torch.bfloat16, device=p.device) for p in parts]
    if outs[0].numel() % 4:
        raise ValueError("the sum pass takes a multiple of 4 elements per chunk")
    fn = c_function("flash_bwd", "hicom_flash_part_sum", [ctypes.c_void_p] * 2 + [ctypes.c_float]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    second = (parts[1].data_ptr(), outs[1].data_ptr(), float(pairs[1][1])) if len(parts) == 2 else (None, None, 0.0)
    check(fn(parts[0].data_ptr(), outs[0].data_ptr(), float(pairs[0][1]), *second, parts[0].shape[0], outs[0].numel(),
             torch.cuda.current_stream(parts[0].device).cuda_stream), "hicom_flash_part_sum")
    return tuple(outs)


def _launch_dkv(q, k, v, lens, do, lse, delta, scale, logit_bias, causal, n_split: Optional[int] = None
                ) -> Tuple[Tensor, Tensor]:
    """K6 (and its sum pass when split) on checked, contiguous CUDA tensors
    (no launch count: see :func:`flash_backward`). ``n_split`` defaults to
    :func:`dkv_splits`; tests force it."""
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    if n_split is None:
        n_split = dkv_splits(b, H, KVH, Lq, Lk, _sm_count(q.device.index or 0))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    parts = (None, None)
    if n_split > 1:
        parts = tuple(torch.empty((n_split, b * KVH, Lk, d), dtype=torch.float32, device=q.device) for _ in range(2))
    head, tail = _bwd_args(q, k, v, lens, do, lse, delta, scale, logit_bias, causal)
    fn = c_function("flash_bwd", "hicom_flash_bwd_dkv", _BWD_ARGS + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                    + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    check(fn(*head, dk.data_ptr(), dv.data_ptr(), *(t.data_ptr() if t is not None else None for t in parts),
             *tail[:6], int(n_split), *tail[6:]), "hicom_flash_bwd_dkv")
    return dk, dv


def backward_operands(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], out: Tensor, lse: Tensor,
                      do: Tensor):
    """Check the backward's inputs and bring them to the kernels' layout:
    returns (q, k, v, int32 lengths or None, dO, lse, delta), contiguous, with
    delta = rowsum(dO * O) in fp32 (one reduction, as ``_flash_bwd_impl``)."""
    b, H, KVH, Lq, Lk, d, lens = _check(q, k, v, kv_lengths, "flash backward")
    if out.shape != q.shape or do.shape != q.shape or lse.shape != (b, H, Lq):
        raise ValueError(f"flash backward: out/dO must be {tuple(q.shape)} and lse {(b, H, Lq)}")
    if out.dtype != torch.bfloat16 or do.dtype != torch.bfloat16 or lse.dtype != torch.float32:
        raise TypeError("flash backward takes bfloat16 out and dO and a float32 lse")
    if any(t.device != q.device for t in (out, lse, do)):
        raise ValueError("flash backward: all inputs must be on one device")
    delta = (do.float() * out.float()).sum(dim=-1)
    return q.contiguous(), k.contiguous(), v.contiguous(), lens, do.contiguous(), lse.contiguous(), delta


def flash_backward(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], out: Tensor, lse: Tensor,
                   do: Tensor, scale: float, logit_bias: float = 0.0, causal: bool = False
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """K5 + K6: (dq, dk, dv) of the attention whose forward gave ``out`` and
    ``lse``; shapes as :func:`flash_forward`, dO like ``out``."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, kv_lengths, out, lse, do, scale, logit_bias, causal)
    ops = backward_operands(q, k, v, kv_lengths, out, lse, do)
    dq = _launch_dq(*ops, scale, logit_bias, causal)
    dk, dv = _launch_dkv(*ops, scale, logit_bias, causal)
    flash_backward.launches += 1
    return dq, dk, dv


flash_backward.launches = 0


def _forward(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], scale: float, logit_bias: float,
             causal: bool, fullblock: bool) -> Tuple[Tensor, Tensor]:
    """K1 on (bh, 1, L, d) rows or K2 on (b, H, L, d); (out, lse) as 4-D / 3-D."""
    if fullblock:
        out, lse = fullblock_attention(q[:, 0], k[:, 0], v[:, 0], scale, logit_bias)
        return out[:, None], lse[:, None]
    return flash_forward(q, k, v, kv_lengths, scale, logit_bias, causal)


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward (JAX ``_flash_bhld``'s custom VJP).

    ``apply(q, k, v, kv_lengths, scale, logit_bias, causal, fullblock)`` on
    (b, H, Lq, d) / (b, KVH, Lk, d) tensors; ``fullblock`` runs K1 on
    (bh, 1, L, d) rows. ``kv_lengths`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, scale, logit_bias, causal, fullblock):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _forward(q, k, v, kv_lengths, scale, logit_bias, causal, fullblock)
        ctx.save_for_backward(q, k, v, kv_lengths, out, lse)
        ctx.args = (scale, logit_bias, causal)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_lengths, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, kv_lengths, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def attend(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], scale: float, logit_bias: float,
           causal: bool, fullblock: bool) -> Tensor:
    """:class:`FlashAttention` when a gradient is wanted, else the forward kernel alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, kv_lengths, scale, logit_bias, causal, fullblock)
    return _forward(q, k, v, kv_lengths, scale, logit_bias, causal, fullblock)[0]


def uses_fullblock(lq: int, lk: int, *, causal: bool, has_lengths: bool, block_q: int, block_k: int) -> bool:
    """Whether ``_flash_fwd_impl`` runs K1 rather than K2 for ungrouped rows:
    no mask, and each whole sequence is exactly one (block_q, block_k) block
    after the TPU's block clamping (at least 8 query rows, 128 keys)."""
    bq, bk = min(block_q, max(lq, 8)), min(block_k, max(lk, 128))
    return not causal and not has_lengths and 0 < lq == bq and 0 < lk == bk


def run_kernel(kernel: str, q: Tensor, k: Tensor, v: Tensor, *, scale: float, logit_bias: float,
               is_causal: bool, kv_lengths: Optional[Tensor]) -> Tensor:
    """Run ``"fullblock"`` (K1) or ``"flash"`` (K2) on (..., L, d) tensors,
    differentiably (:func:`attend`).

    For K2 the leading axis is the batch that ``kv_lengths`` indexes and the
    axes between it and (L, d) are heads; a 4-D q with fewer k heads is GQA."""
    if kernel == "fullblock":
        shape = lambda x: (-1, 1) + tuple(x.shape[-2:])  # noqa: E731
    else:
        shape = lambda x: (x.shape[0] if x.ndim > 2 else 1, -1) + tuple(x.shape[-2:])  # noqa: E731
    out = attend(q.reshape(shape(q)), k.reshape(shape(k)), v.reshape(shape(v)), kv_lengths, scale, logit_bias,
                 is_causal, kernel == "fullblock")
    return out.reshape(q.shape)


def flash_attention(
    q: Tensor,  # (..., Lq, d)
    k: Tensor,  # (..., Lk, d)
    v: Tensor,
    *,
    scale: Optional[float] = None,
    logit_bias: float = 0.0,
    mask: Optional[Tensor] = None,
    is_causal: bool = False,
    kv_lengths: Optional[Tensor] = None,  # per-LEADING-batch valid kv lengths
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> Tensor:
    """Causal and/or kv-length masked attention; arbitrary masks take ``sdpa``'s
    plain path instead. ``kv_lengths`` (batch,) broadcasts over the head axes
    between the batch axis and the (L, d) tail. The block sizes only select K1
    or K2 (:func:`uses_fullblock`), as on the TPU."""
    if mask is not None:
        raise ValueError("flash_attention supports causal/length masks only")
    fullblock = uses_fullblock(q.shape[-2], k.shape[-2], causal=is_causal, has_lengths=kv_lengths is not None,
                               block_q=block_q, block_k=block_k)
    return run_kernel("fullblock" if fullblock else "flash", q, k, v,
                      scale=float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5),
                      logit_bias=float(logit_bias), is_causal=is_causal, kv_lengths=kv_lengths)


def flash_attention_gqa(
    q: Tensor,  # (b, H, L, d)
    k: Tensor,  # (b, KVH, S, d)
    v: Tensor,
    *,
    scale: Optional[float] = None,
    logit_bias: float = 0.0,
    is_causal: bool = False,
    kv_lengths: Optional[Tensor] = None,  # (b,)
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> Tensor:
    """Grouped-query attention without repeating KV (always K2). ``block_q`` and
    ``block_k`` are kept for the JAX signature; the kernel tiles itself."""
    if q.shape[1] % k.shape[1]:
        raise ValueError("query heads must be a multiple of kv heads")
    scale = float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return attend(q, k, v, kv_lengths, scale, float(logit_bias), is_causal, False)
