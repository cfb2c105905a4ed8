"""Local-compressor tile attention: the ``csrc/local_attn.cu`` kernel and its plain twin.

Replaces the Pallas TPU kernel ``hicom_tpu/ops/local_attn.py:_tile_attn_kernel``
(K4): one query per (kt, kh, kw) tile of a (t, h, w, d) volume attends over its
tile's keys, read straight from the volumes with no retiled copy. Scale and
bias may be device tensors (the clip-scale path), so no host sync is needed.
Divisible tile grids only; the overlap case stays on ``tile_thw`` + ``sdpa``.
K4 has no backward, on the TPU or here: under grad mode the CUDA wrapper
refuses inputs that require a gradient, and the projector takes ``tile_thw`` +
``sdpa`` there, the path the JAX train step runs.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from .cuda_build import c_function, check

Tensor = torch.Tensor


def tile_reference(q: Tensor, key: Tensor, value: Tensor, kernel: tuple, scale, logit_bias) -> Tensor:
    """Plain twin: fp32 logits and softmax, p rounded to value's dtype."""
    t, h, w, qk = key.shape
    kt, kh, kw = kernel
    t1, h1, w1 = t // kt, h // kh, w // kw
    dv = value.shape[-1]

    def tiles(x):
        x = x.reshape(t1, kt, h1, kh, w1, kw, x.shape[-1]).permute(0, 2, 4, 1, 3, 5, 6)
        return x.reshape(t1 * h1 * w1, kt * kh * kw, x.shape[-1])

    logits = torch.einsum("gkd,gd->gk", tiles(key).float(), q.reshape(-1, qk).float())
    logits = logits * scale + logit_bias
    p = torch.softmax(logits, dim=-1).to(value.dtype)
    out = torch.einsum("gk,gkd->gd", p.float(), tiles(value).float())
    return out.reshape(t1, h1, w1, dv).to(q.dtype)


def fused_tile_attention(
    q: Tensor,  # (t1, h1, w1, qk): one query per tile
    key: Tensor,  # (t, h, w, qk)
    value: Tensor,  # (t, h, w, dv)
    kernel: tuple,  # (kt, kh, kw)
    scale: Union[float, Tensor],
    logit_bias: Union[float, Tensor] = 0.0,
) -> Tensor:
    """softmax(q·K_tileᵀ·scale + bias)·V_tile per (kt, kh, kw) tile."""
    t, h, w, qk = key.shape
    kt, kh, kw = kernel
    if (t % kt, h % kh, w % kw) != (0, 0, 0):
        raise ValueError("tile attention needs divisible tiles")
    if tuple(q.shape[:3]) != (t // kt, h // kh, w // kw) or q.shape[3] != qk:
        raise ValueError(f"query grid {tuple(q.shape)} does not match tiles of {tuple(key.shape)}")
    if q.device.type == "cpu":
        return tile_reference(q, key, value, kernel, scale, logit_bias)
    if torch.is_grad_enabled() and any(isinstance(x, Tensor) and x.requires_grad
                                       for x in (q, key, value, scale, logit_bias)):
        raise RuntimeError("the tile kernel has no backward: take tile_thw + sdpa when a gradient is needed")

    dv = value.shape[-1]
    if any(x.dtype != torch.bfloat16 for x in (q, key, value)):
        raise TypeError("tile kernel takes bfloat16 q, key and value")
    if value.shape[:3] != key.shape[:3] or qk % 2 or dv % 2 or kt * kh * kw > 64:
        raise ValueError("tile kernel: unsupported shapes")
    if any(x.device != q.device for x in (key, value)):
        raise ValueError("tile kernel: all inputs must be on one device")
    q, key, value = q.contiguous(), key.contiguous(), value.contiguous()
    scale_t = torch.as_tensor(scale, dtype=torch.float32, device=q.device).reshape(1).contiguous()
    bias_t = torch.as_tensor(logit_bias, dtype=torch.float32, device=q.device).reshape(1).contiguous()
    out = torch.empty(q.shape[:3] + (dv,), dtype=q.dtype, device=q.device)
    fn = c_function("local_attn", "hicom_tile_attention", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                    + [ctypes.c_void_p])
    status = fn(q.data_ptr(), key.data_ptr(), value.data_ptr(), scale_t.data_ptr(), bias_t.data_ptr(),
                out.data_ptr(), t, h, w, qk, dv, kt, kh, kw, torch.cuda.current_stream(q.device).cuda_stream)
    check(status, "hicom_tile_attention")
    fused_tile_attention.launches += 1
    return out


fused_tile_attention.launches = 0
