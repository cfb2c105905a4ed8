"""Flash-attention forward: the Hopper kernel of ``csrc/flash_fwd.cu`` and its plain twin.

One CUDA kernel takes the place of two Pallas TPU kernels of
``hicom_tpu/ops/flash_attention.py``:

* :func:`fullblock_attention` replaces ``_fullblock_kernel`` (K1): unmasked
  attention with every row seeing the whole kv, the SigLIP tower shape;
* :func:`flash_forward` replaces ``_flash_kernel`` (K2): causal (aligned
  bottom-right) and ``kv_lengths`` masks, and grouped-query attention with the
  kv head indexed as ``h // g`` instead of folded rows.

Both return ``(out, lse)``; the lse is what a backward pass will need. Each
wrapper runs the plain PyTorch twin for CPU tensors and launches the kernel for
CUDA tensors, or raises; ``launches`` counts kernel launches.

:func:`flash_attention` and :func:`flash_attention_gqa` keep the signatures of
the JAX entry points. :func:`uses_fullblock` is the one rule that chooses
between the two kernels, as ``_flash_fwd_impl`` chooses on the TPU; ``sdpa``
and :func:`flash_attention` both go through it and :func:`run_kernel`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_build import c_function, check

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 256
NEG_INF = -1e30

Tensor = torch.Tensor


def flash_reference(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], scale: float,
                    logit_bias: float, causal: bool) -> Tuple[Tensor, Tensor]:
    """Plain twin of the kernel: q (b, H, Lq, d), k/v (b, KVH, Lk, d), kv_lengths (b,).

    fp32 logits, masked entries at -1e30 (the TPU kernel's convention), causal
    mask aligned bottom-right, p rounded to v's dtype before the weighted sum,
    denominator ``max(l, 1e-30)``. Returns out (q.dtype) and lse (b, H, Lq) fp32.
    """
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    g = H // KVH
    qg = q.reshape(b, KVH, g, Lq, d).float()
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale + logit_bias
    k_pos = torch.arange(Lk, device=q.device)
    valid = torch.ones((b, 1, 1, Lq, Lk), dtype=torch.bool, device=q.device)
    if kv_lengths is not None:
        valid = valid & (k_pos[None, :] < kv_lengths.to(q.device)[:, None]).reshape(b, 1, 1, 1, Lk)
    if causal:
        q_pos = torch.arange(Lq, device=q.device)
        valid = valid & (k_pos[None, :] <= q_pos[:, None] + (Lk - Lq))
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype).float(), v.float()) / denom
    lse = (m + torch.log(denom))[..., 0]
    return out.reshape(b, H, Lq, d).to(q.dtype), lse.reshape(b, H, Lq)


def _launch(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Optional[Tensor], scale: float,
            logit_bias: float, causal: bool) -> Tuple[Tensor, Tensor]:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash kernel takes q (b,H,Lq,d), k/v (b,KVH,Lk,d); got {q.shape}, {k.shape}, {v.shape}")
    b, H, Lq, d = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or H % KVH:
        raise ValueError(f"flash kernel: incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("flash kernel takes bfloat16 q, k and v")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash kernel: q, k and v must be on one device")
    if d % 8 or d > 128 or (d + 15) // 16 * 16 not in (32, 64, 80, 128):
        raise ValueError(f"flash kernel: head dim {d} not supported")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = None
    if kv_lengths is not None:
        lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (b,):
            raise ValueError(f"kv_lengths must be ({b},), got {tuple(lens.shape)}")
    out = torch.empty_like(q)
    lse = torch.empty((b, H, Lq), dtype=torch.float32, device=q.device)
    fn = c_function("flash_fwd", "hicom_flash_fwd", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                    + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr() if lens is not None else None,
                out.data_ptr(), lse.data_ptr(), b, H, KVH, Lq, Lk, d, float(scale), float(logit_bias),
                int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    check(status, "hicom_flash_fwd")
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


def uses_fullblock(lq: int, lk: int, *, causal: bool, has_lengths: bool, block_q: int, block_k: int) -> bool:
    """Whether ``_flash_fwd_impl`` runs K1 rather than K2 for ungrouped rows:
    no mask, and each whole sequence is exactly one (block_q, block_k) block
    after the TPU's block clamping (at least 8 query rows, 128 keys)."""
    bq, bk = min(block_q, max(lq, 8)), min(block_k, max(lk, 128))
    return not causal and not has_lengths and 0 < lq == bq and 0 < lk == bk


def run_kernel(kernel: str, q: Tensor, k: Tensor, v: Tensor, *, scale: float, logit_bias: float,
               is_causal: bool, kv_lengths: Optional[Tensor]) -> Tensor:
    """Run ``"fullblock"`` (K1) or ``"flash"`` (K2) on (..., L, d) tensors.

    For K2 the leading axis is the batch that ``kv_lengths`` indexes and the
    axes between it and (L, d) are heads; a 4-D q with fewer k heads is GQA."""
    if kernel == "fullblock":
        rows = lambda x: x.reshape((-1,) + tuple(x.shape[-2:]))  # noqa: E731
        out, _ = fullblock_attention(rows(q), rows(k), rows(v), scale, logit_bias)
    else:
        bhld = lambda x: x.reshape((x.shape[0] if x.ndim > 2 else 1, -1) + tuple(x.shape[-2:]))  # noqa: E731
        out, _ = flash_forward(bhld(q), bhld(k), bhld(v), kv_lengths, scale, logit_bias, is_causal)
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
    out, _ = flash_forward(q, k, v, kv_lengths, scale, float(logit_bias), is_causal)
    return out
