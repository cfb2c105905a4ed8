"""Scaled-dot-product attention with fp32 softmax, and its dispatcher to the kernels.

Port of ``hicom_tpu/ops/attention.py``. ``sdpa`` keeps every rule of the JAX
plain (einsum) path: fp32 logits and softmax, then a cast back; an additive
``logit_bias``; the causal mask aligned bottom-right (``tril(k=klen-qlen)``,
filled with -inf); ``kv_lengths`` and boolean ``mask`` filled with
``finfo(float32).min``; GQA grouped without repeating KV.

``sdpa`` sends CUDA tensors to the flash kernels exactly where the JAX
``auto`` rule sends TPU arrays to Pallas (:func:`flash_route`), and everything
else to the plain path.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .flash_attention import DEFAULT_BLOCK_Q, run_kernel, uses_fullblock

Tensor = torch.Tensor
FULL_BLOCK_MAX = 1024  # whole-sequence single-block limit (JAX HICOM_FLASH_FULLBLOCK_MAX default)
MIN_LANE = 64  # JAX HICOM_FLASH_MIN_LANE default


def flash_route(q_shape, k_shape, *, mask=None, scale=None, logit_bias=0.0, is_causal=False,
                kv_lengths=None) -> Optional[str]:
    """The JAX ``auto`` rule, without its device test: None for the plain path,
    else the kernel that the TPU would run, ``"fullblock"`` (K1) or ``"flash"`` (K2)."""
    grouped = len(q_shape) == 4 and len(k_shape) == 4 and q_shape[1] != k_shape[1]
    lq, lk, d = q_shape[-2], k_shape[-2], q_shape[-1]
    fits_one_block = 0 < lq <= FULL_BLOCK_MAX and 0 < lk <= FULL_BLOCK_MAX
    lane_ok = d % MIN_LANE == 0
    full_block = fits_one_block and d % 8 == 0 and not grouped
    if (mask is not None or isinstance(scale, Tensor) or isinstance(logit_bias, Tensor)
            or lq * lk < 128 * 128 or not (lane_ok or full_block)):
        return None
    if grouped:  # the GQA entry always runs K2
        return "flash"
    block = FULL_BLOCK_MAX if fits_one_block and d % 128 != 0 else DEFAULT_BLOCK_Q
    fullblock = uses_fullblock(lq, lk, causal=is_causal, has_lengths=kv_lengths is not None,
                               block_q=block, block_k=block)
    return "fullblock" if fullblock else "flash"


def sdpa(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    scale: Optional[Union[float, Tensor]] = None,
    logit_bias: Union[float, Tensor] = 0.0,
    mask: Optional[Tensor] = None,
    is_causal: bool = False,
    kv_lengths: Optional[Tensor] = None,
) -> Tensor:
    """Attention over the last two axes: q (..., Q, d), k/v (..., K, d).

    ``mask`` is boolean (..., Q, K), True = attend; ``kv_lengths`` (batch,)
    right-aligned valid kv lengths. Output in q's dtype.
    """
    kernel = flash_route(q.shape, k.shape, mask=mask, scale=scale, logit_bias=logit_bias, is_causal=is_causal,
                         kv_lengths=kv_lengths) if q.is_cuda else None
    if kernel is not None:
        return run_kernel(kernel, q, k, v, scale=float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5),
                          logit_bias=float(logit_bias), is_causal=is_causal, kv_lengths=kv_lengths)
    return _sdpa_plain(q, k, v, scale=scale, logit_bias=logit_bias, mask=mask,
                       is_causal=is_causal, kv_lengths=kv_lengths)


def _sdpa_plain(q, k, v, *, scale, logit_bias, mask, is_causal, kv_lengths) -> Tensor:
    if q.ndim == 4 and k.ndim == 4 and q.shape[1] != k.shape[1]:
        # grouped without materializing repeated KV: (b, KVH, g, L, d)
        b, H, L, d = q.shape
        KVH = k.shape[1]
        qg = q.reshape(b, KVH, H // KVH, L, d)
        if mask is not None and mask.ndim == 4:
            if mask.shape[1] == H:  # per-head mask: regroup alongside q
                mask = mask.reshape(b, KVH, H // KVH, *mask.shape[2:])
            else:  # broadcast over heads (shape (b, 1, Q, K))
                mask = mask[:, :, None]
        out = _sdpa_plain(qg, k[:, :, None], v[:, :, None], scale=scale, logit_bias=logit_bias,
                          mask=mask, is_causal=is_causal, kv_lengths=kv_lengths)
        return out.reshape(b, H, L, d)

    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits * scale + logit_bias
    neg = torch.finfo(torch.float32).min
    if is_causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((qlen, klen), dtype=torch.bool, device=q.device).tril(diagonal=klen - qlen)
        logits = logits.masked_fill(~causal, float("-inf"))
    if kv_lengths is not None:
        klen = logits.shape[-1]
        len_mask = torch.arange(klen, device=q.device)[None, :] < kv_lengths.to(q.device)[:, None]
        len_mask = len_mask.reshape((kv_lengths.shape[0],) + (1,) * (logits.ndim - 2) + (klen,))
        logits = logits.masked_fill(~len_mask, neg)
    if mask is not None:
        logits = logits.masked_fill(~mask.to(q.device, torch.bool), neg)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def split_heads(x: Tensor, num_heads: int) -> Tensor:
    """(..., L, H*d) -> (..., H, L, d)"""
    *lead, L, D = x.shape
    return x.reshape(*lead, L, num_heads, D // num_heads).movedim(-2, -3)


def merge_heads(x: Tensor) -> Tensor:
    """(..., H, L, d) -> (..., L, H*d)"""
    x = x.movedim(-3, -2)
    *lead, L, H, d = x.shape
    return x.reshape(*lead, L, H * d)


def multi_head_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    num_heads: int,
    *,
    scale: Optional[Union[float, Tensor]] = None,
    logit_bias: Union[float, Tensor] = 0.0,
    mask: Optional[Tensor] = None,
    is_causal: bool = False,
) -> Tensor:
    """MHA over already-projected q/k/v of shape (..., L, H*d); ``mask`` is
    (..., Q, K) and broadcast over heads."""
    qh, kh, vh = split_heads(q, num_heads), split_heads(k, num_heads), split_heads(v, num_heads)
    if mask is not None:
        mask = mask[..., None, :, :]
    out = sdpa(qh, kh, vh, scale=scale, logit_bias=logit_bias, mask=mask, is_causal=is_causal)
    return merge_heads(out)
