"""Ring attention: exact attention over a sequence split in equal chunks across ranks.

Port of ``hicom_tpu/parallel/ring.py``. Each rank holds the chunk of q, k and
v at its rank index in the group (global sequence = the chunks in rank
order). At step s a rank holds the key chunk ``src = (idx - s) % n`` and runs
one block of attention on it (:func:`ring_block`):

* under causality it skips a block above the diagonal (``src > idx``);
* the diagonal block (``src == idx``) is K2 with its causal mask, which is
  aligned bottom-right and equals the global-position mask because every
  chunk has the same length;
* a block below the diagonal, or any block without causality, is K2
  without the mask;
* global ``kv_lengths`` become the block's ``clamp(len - src * Lk, 0, Lk)``.

Each block gives K2's fp32 partials without its merge
(:func:`~..ops.flash_attention.flash_forward_partials`, its plain twin on
the CPU); after the last step the rank merges all its blocks' partials with
one launch of the merge kernel
(:func:`~..ops.flash_attention.merge_partials`). A block with no valid key
for a row has a max near -1e30 and weighs 0 beside any block that has one.
JAX keeps a running (max, sum, accumulator) in fp32 over einsum blocks
instead: the same fp32 algebra, merged once at the end.

The KV chunks rotate with ``dist.batch_isend_irecv`` (every send posted
together with its receive, as ``ppermute`` is), started before a block is
computed and waited for after it; the last step sends nothing, and at world
size 1 nothing is sent at all.

:func:`ring_prefill` runs the decoder on this rank's chunk of a prompt with
every layer's attention through :func:`ring_attention`
(``Qwen2Model.forward(..., ring_group=)``), then gathers the chunks' KV
caches in rank order into one cache on every rank. :func:`ring_self_attention`
splits whole q/k/v itself. Every rank calls these with the same arguments.
``mesh`` is a ``DeviceMesh`` (``parallel/mesh.create_mesh``) or None for this
process alone (``parallel/mesh.flat_group``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.attention import gather_rows, group_rank, group_size
from ..ops.flash_attention import flash_forward_partials, merge_partials
from .mesh import flat_group

Tensor = torch.Tensor


def send_recv(tensors, group, shift: int = 1):
    """Post, all together, a send of each tensor to the rank ``shift`` ahead in
    the ring and a receive of its counterpart from the rank ``shift`` behind.
    Returns (received tensors, the requests to wait for)."""
    n, idx = group_size(group), group_rank(group)
    peer = lambda i: dist.get_global_rank(group, i % n)  # noqa: E731
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, recv):
        ops += [dist.P2POp(dist.isend, t, peer(idx + shift), group),
                dist.P2POp(dist.irecv, r, peer(idx - shift), group)]
    return recv, dist.batch_isend_irecv(ops)


def ring_block(q: Tensor, k: Tensor, v: Tensor, idx: int, src: int, *, scale: float, is_causal: bool = False,
               kv_lengths: Optional[Tensor] = None) -> Optional[Tuple[Tensor, Tensor, Tensor]]:
    """Query chunk ``idx`` against key chunk ``src``: K2's fp32 partials
    (o_part, m_part, l_part), or None for a block above the diagonal under
    causality. ``kv_lengths`` (b,) are global."""
    if is_causal and src > idx:
        return None
    Lk = k.shape[2]
    lens = None if kv_lengths is None else (kv_lengths - src * Lk).clamp(0, Lk)
    return flash_forward_partials(q, k, v, lens, scale, 0.0, is_causal and src == idx)


def ring_attention(q: Tensor, k: Tensor, v: Tensor, group, *, scale: Optional[float] = None,
                   is_causal: bool = False, kv_lengths: Optional[Tensor] = None) -> Tensor:
    """Exact attention for this rank's chunks q (b, H, Lq, d), k/v (b, KVH,
    Lk, d) of a sequence split over ``group``; masks at global positions,
    ``kv_lengths`` (b,) global. Returns this rank's (b, H, Lq, d) chunk."""
    Lq, d = q.shape[2], q.shape[3]
    if is_causal and Lq != k.shape[2]:
        raise ValueError(f"causal ring attention needs equal q and kv chunks, got {Lq} and {k.shape[2]}")
    scale = float(scale) if scale is not None else d**-0.5
    n, idx = group_size(group), group_rank(group)
    ck, cv = k.contiguous(), v.contiguous()
    parts = []
    for s in range(n):
        pending = send_recv((ck, cv), group) if s < n - 1 else None
        part = ring_block(q, ck, cv, idx, (idx - s) % n, scale=scale, is_causal=is_causal, kv_lengths=kv_lengths)
        if part is not None:
            parts.append(part)
        if pending is not None:
            (ck, cv), works = pending
            for w in works:
                w.wait()
    return merge_partials(*(torch.cat(t) for t in zip(*parts)), q.dtype)[0]


def ring_self_attention(q: Tensor, k: Tensor, v: Tensor, mesh, axis: str = "dp", **kwargs) -> Tensor:
    """Whole q (b, H, L, d), k/v (b, KVH, L, d), the same on every rank: this
    rank's sequence chunk along mesh axis ``axis`` through
    :func:`ring_attention`, then every rank's output chunk gathered, so each
    rank returns the whole (b, H, L, d) output."""
    if not isinstance(axis, str):
        raise ValueError("ring attention rotates over a single mesh axis")
    group = flat_group(mesh, (axis,))[0]
    n, idx = group_size(group), group_rank(group)
    L = q.shape[2]
    if L % n:
        raise ValueError(f"sequence {L} not divisible by {n} ranks")
    sl = slice(idx * L // n, (idx + 1) * L // n)
    out = ring_attention(q[:, :, sl], k[:, :, sl], v[:, :, sl], group, **kwargs)
    return torch.cat(list(gather_rows(out, group)), dim=2)


@torch.inference_mode()
def ring_prefill(model, embeds: Tensor, positions: Tensor, mesh, axis: str = "dp", cache_len: Optional[int] = None):
    """Decoder prefill with the sequence split over mesh axis ``axis``.

    ``embeds`` (b, S, D) are the spliced, unpadded prompt and ``positions``
    (b, S) its rope positions, the same on every rank. S is padded to a
    multiple of the n ranks (zero embeddings, positions continuing; the
    padded tail is causally invisible to real tokens and masked out of the
    cache). Each rank runs the decoder on its S/n tokens at their global
    positions, writing its slots of a ``cache_len``-slot cache (default: the
    padded S); the ranks then all-gather the other chunks' slots in rank
    order. Returns ``(last_hidden, cache)``: the final-norm hidden (b, 1, D)
    of token S - 1 (broadcast from the rank that holds it) and a
    :class:`~..models.qwen2.KVCache` with ``length = S`` and ``valid = slot <
    S``, the same on every rank, ready for
    :func:`~..models.generate.decode_tokens`."""
    from ..models.qwen2 import KVCache

    group = flat_group(mesh, (axis,))[0]
    n, idx = group_size(group), group_rank(group)
    b, S, _ = embeds.shape
    S_pad = -(-S // n) * n
    if S_pad != S:
        embeds = torch.cat([embeds, embeds.new_zeros((b, S_pad - S, embeds.shape[2]))], dim=1)
        tail = positions[:, -1:] + 1 + torch.arange(S_pad - S, device=positions.device)[None]
        positions = torch.cat([positions, tail.to(positions.dtype)], dim=1)
    cache_len = S_pad if cache_len is None else cache_len
    if cache_len < S_pad:
        raise ValueError(f"cache_len {cache_len} < padded prompt {S_pad}")
    tc = model.config
    decoder = model.model
    cache = KVCache.zeros(tc.num_hidden_layers, b, tc.num_key_value_heads, cache_len, tc.head_dim,
                          decoder.norm.weight.dtype, embeds.device)
    S_loc = S_pad // n
    mine = slice(idx * S_loc, (idx + 1) * S_loc)
    cache.length = idx * S_loc  # this chunk's slots
    hidden = decoder(embeds[:, mine], positions[:, mine], cache, prefill_from_empty=True, ring_group=group)
    if n > 1:
        for t in (cache.k, cache.v):
            parts = gather_rows(t[:, :, :, mine].contiguous(), group)
            for r in range(n):
                t[:, :, :, r * S_loc:(r + 1) * S_loc] = parts[r]
    cache.length = S
    cache.valid.copy_((torch.arange(cache_len, device=embeds.device) < S)[None].expand(b, cache_len))
    owner = (S - 1) // S_loc
    row = S - 1 - owner * S_loc
    last = hidden[:, row:row + 1].contiguous() if idx == owner else hidden.new_empty((b, 1, hidden.shape[2]))
    if n > 1:
        dist.broadcast(last, src=dist.get_global_rank(group, owner), group=group)
    return last, cache
