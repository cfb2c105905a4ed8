"""Decode-step attention over the KV cache: the ``csrc/flash_decode.cu`` kernel and its twin.

Replaces the Pallas TPU kernel ``hicom_tpu/ops/flash_decode.py:_decode_kernel``
(K3). One query token per row attends over the cache slots its bitmap marks,
for a bf16 cache or an int8 cache with per-slot scales. With int8, the k scales
multiply the logits and the v scales multiply p for the accumulator only, not
the denominator, as on the TPU. The CUDA kernel splits the slot axis into
chunks of :data:`DECODE_CHUNK` slots, one warp each, skips chunks with no valid
slot, and merges the chunks' partials in a second small kernel (see the
source); :func:`chunked_decode_reference` is that path in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .cuda_build import c_function, check

NEG_INF = -1e30
DECODE_CHUNK = 32  # the kernel's slots per block

Tensor = torch.Tensor


def decode_reference(q: Tensor, k: Tensor, v: Tensor, slot_mask: Tensor, k_scale: Optional[Tensor],
                     v_scale: Optional[Tensor], scale: float) -> Tensor:
    """Plain twin: q (b, H, 1, d); k/v (b, KVH, S, d) in q's dtype or int8."""
    b, H, _, d = q.shape
    KVH = k.shape[1]
    g = H // KVH
    qg = q.reshape(b, KVH, g, d).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k.to(q.dtype).float())
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    logits = logits * scale
    logits = torch.where(slot_mask[:, None, None, :].bool(), logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = e * v_scale[:, :, None, :] if v_scale is not None else e
    out = torch.einsum("bkgs,bksd->bkgd", p.to(q.dtype).float(), v.to(q.dtype).float()) / denom
    return out.reshape(b, H, 1, d).to(q.dtype)


def chunked_decode_reference(q: Tensor, k: Tensor, v: Tensor, slot_mask: Tensor, k_scale: Optional[Tensor],
                             v_scale: Optional[Tensor], scale: float) -> Tensor:
    """The kernel's chunked path in plain PyTorch, shapes as :func:`decode_reference`:
    per chunk of :data:`DECODE_CHUNK` slots with a valid one, its max m, the
    fp32 sum l of p = exp(logit - m) and the sum of p (times the v scale, in
    q's dtype) times v; an empty chunk weighs 0. The chunks merge with weights
    exp(m - M), M their largest max; a row with no valid slot at all is the
    plain average of its S values (times their v scales)."""
    b, H, _, d = q.shape
    KVH, S = k.shape[1], k.shape[2]
    g, n = H // KVH, -(-S // DECODE_CHUNK)
    pad = n * DECODE_CHUNK - S
    vf = v.to(q.dtype).float()
    vsf = v_scale.float() if v_scale is not None else torch.ones((b, KVH, S), device=q.device)
    logits = torch.einsum("bkgd,bksd->bkgs", q.reshape(b, KVH, g, d).float(), k.to(q.dtype).float())
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    mask = torch.nn.functional.pad(slot_mask.bool(), (0, pad))
    logits = torch.nn.functional.pad(logits * scale, (0, pad))
    logits = torch.where(mask[:, None, None, :], logits, torch.full_like(logits, NEG_INF)).unflatten(-1, (n, -1))
    m = logits.amax(dim=-1)  # (b, KVH, g, n)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    pv = (p * torch.nn.functional.pad(vsf, (0, pad)).unflatten(-1, (n, -1))[:, :, None]).to(q.dtype).float()
    o = torch.einsum("bkgnc,bkncd->bkgnd", pv, torch.nn.functional.pad(vf, (0, 0, 0, pad)).unflatten(2, (n, -1)))
    busy = mask.unflatten(-1, (n, -1)).any(dim=-1)[:, None, None, :]  # (b, 1, 1, n)
    M = torch.where(busy, m, torch.full_like(m, float("-inf"))).amax(dim=-1, keepdim=True)
    w = torch.where(busy, torch.exp(m - torch.where(busy, M, m)), torch.zeros_like(m))
    out = (w[..., None] * o).sum(dim=-2) / (w * l).sum(dim=-1, keepdim=True).clamp_min(1e-30)
    clear = ~busy.any(dim=-1, keepdim=True)  # (b, 1, 1, 1): the uniform average
    out = torch.where(clear, (vf * vsf[..., None]).sum(dim=2)[:, :, None] / S, out)
    return out.reshape(b, H, 1, d).to(q.dtype)


_workspaces: Dict[Tuple[torch.device, int], Tensor] = {}


def _workspace(device: torch.device, stream: int, numel: int) -> Tensor:
    """The split-KV partials' fp32 scratch, one buffer per (device, stream),
    grown on demand. Launches on one stream run in order and each writes the
    partials before its merge reads them, so every layer and step reuses it."""
    ws = _workspaces.get((device, stream))
    if ws is None or ws.numel() < numel:
        ws = _workspaces[(device, stream)] = torch.empty(numel, dtype=torch.float32, device=device)
    return ws


def flash_decode(
    q: Tensor,  # (b, H, 1, d)
    k: Tensor,  # (b, KVH, S, d): int8 codes or q's dtype
    v: Tensor,
    slot_mask: Tensor,  # (b, S) bool, True = attend
    *,
    k_scale: Optional[Tensor] = None,  # (b, KVH, S) f32 (int8 cache)
    v_scale: Optional[Tensor] = None,
    scale: Optional[float] = None,
) -> Tensor:
    """One-token decode attention; returns (b, H, 1, d) in q's dtype."""
    b, H, L, d = q.shape
    if L != 1:
        raise ValueError("flash_decode takes one query token per row")
    KVH, S = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError("query heads must be a multiple of kv heads")
    scale = float(scale) if scale is not None else 1.0 / (d**0.5)
    quantized = k_scale is not None
    if q.device.type == "cpu":
        return decode_reference(q, k, v, slot_mask, k_scale, v_scale, scale)

    g = H // KVH
    if q.dtype != torch.bfloat16:
        raise TypeError("decode kernel takes a bfloat16 query")
    if quantized:
        if k.dtype != torch.int8 or v.dtype != torch.int8 or v_scale is None:
            raise TypeError("int8 decode needs int8 k/v and both scale tensors")
        k_scale = k_scale.to(torch.float32).contiguous()
        v_scale = v_scale.to(torch.float32).contiguous()
        if k_scale.shape != (b, KVH, S) or v_scale.shape != (b, KVH, S):
            raise ValueError("cache scales must be (b, KVH, S)")
    elif k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError("decode kernel takes a bfloat16 or int8 cache")
    if k.shape != (b, KVH, S, d) or v.shape != k.shape or slot_mask.shape != (b, S):
        raise ValueError(f"decode kernel: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} mask {tuple(slot_mask.shape)}")
    if d != 128 or g not in (1, 2, 4, 6, 7, 8):
        raise ValueError(f"decode kernel: head dim {d} / group {g} not supported")
    if any(t.device != q.device for t in (k, v, slot_mask)):
        raise ValueError("decode kernel: all inputs must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # a bool mask is read as bytes in place: no conversion launch per layer
    mask = (slot_mask.view(torch.uint8) if slot_mask.dtype == torch.bool else slot_mask.to(torch.uint8)).contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    workspace = c_function("flash_decode", "hicom_decode_workspace", [ctypes.c_int] * 4, ctypes.c_longlong)
    ws = _workspace(q.device, stream, workspace(b, KVH, g, S))
    out = torch.empty_like(q)
    fn = c_function("flash_decode", "hicom_flash_decode",
                    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
                mask.data_ptr(), ws.data_ptr(), out.data_ptr(), b, KVH, g, S, d, int(quantized), scale, stream)
    check(status, "hicom_flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
