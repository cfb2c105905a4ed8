"""Local-compressor tile attention: the ``csrc/local_attn.cu`` kernel and its plain versions.

Replaces the Pallas TPU kernel ``hicom_tpu/ops/local_attn.py:_tile_attn_kernel``
(K4): one query per (kt, kh, kw) tile of a (t, h, w, d) volume attends over its
tile's keys, read straight from the volumes with no retiled copy.
:func:`takes_tile_kernel` states which grids and widths the kernel takes; the
projector runs ``tile_thw`` + ``sdpa`` on the others. Scale and bias pass by
value when they are numbers and by device pointer when they are tensors on the
card (the clip-scale path), so a call never waits for the device.
K4 has no backward, on the TPU or here: the CUDA wrapper refuses inputs that
require a gradient under grad mode, and the projector takes ``tile_thw`` +
``sdpa`` there, the path the JAX train step runs. The kernel takes bf16 or
fp32 q, key and value of one dtype (JAX's kernel is dtype-generic); in fp32 it
rounds nothing, p included.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from .cuda_build import c_function, check, plain_operands
from .flash_attention import _sm_count

Tensor = torch.Tensor
MAX_K = 64  # keys per tile
MAX_WIDTH_BYTES = 16384  # a row of qk or dv: 16-byte chunks of 8 warps x 32 threads x 4 (8192 bf16, 4096 fp32)
MAX_SEGMENT_BYTES = 49152  # kw rows of max(qk, dv): one 48 KB slot of the kernel's ring
TILE_DTYPES = (torch.bfloat16, torch.float32)  # the kernel's instances


def takes_tile_kernel(thw: Tuple[int, int, int], qk: int, dv: int, kernel: tuple,
                      dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether K4 computes the tile attention of one (t, h, w) volume of
    ``dtype`` elements: the tiles divide it, K = kt * kh * kw <= 64, qk and
    dv are multiples of 8, a row is at most 16 KB and a segment of kw rows fits
    a 48 KB ring slot (bytes counted in ``dtype``; the wrapper checks the types
    themselves)."""
    (t, h, w), (kt, kh, kw) = thw, kernel
    row = max(qk, dv) * dtype.itemsize
    return (t % kt == 0 and h % kh == 0 and w % kw == 0 and kt * kh * kw <= MAX_K and qk % 8 == 0
            and dv % 8 == 0 and row <= MAX_WIDTH_BYTES and kw * row <= MAX_SEGMENT_BYTES)


def _tiles(x: Tensor, kernel: tuple) -> Tensor:
    """(t, h, w, d) -> (tiles, K, d), keys ordered (it, ih, iw) as ``tile_thw`` orders them."""
    t, h, w, d = x.shape
    kt, kh, kw = kernel
    x = x.reshape(t // kt, kt, h // kh, kh, w // kw, kw, d).permute(0, 2, 4, 1, 3, 5, 6)
    return x.reshape(-1, kt * kh * kw, d)


def tile_reference(q: Tensor, key: Tensor, value: Tensor, kernel: tuple, scale, logit_bias) -> Tensor:
    """Plain version: fp32 logits and softmax, p rounded to value's dtype."""
    logits = torch.einsum("gkd,gd->gk", _tiles(key, kernel).float(), q.reshape(-1, q.shape[-1]).float())
    logits = logits * scale + logit_bias
    p = torch.softmax(logits, dim=-1).to(value.dtype)
    out = torch.einsum("gk,gkd->gd", p.float(), _tiles(value, kernel).float())
    return out.reshape(q.shape[:3] + (value.shape[-1],)).to(q.dtype)


def chunked_tile_reference(q: Tensor, key: Tensor, value: Tensor, kernel: tuple, scale, logit_bias) -> Tensor:
    """Plain path in the kernel's order: each segment's kw logits as fp32
    dot products, the softmax, then the value rows folded one at a time into
    an fp32 accumulator in tile order (segments (it, ih), kw rows each)."""
    kt, kh, kw = kernel
    segments = _tiles(key, kernel).float().reshape(-1, kt * kh, kw, key.shape[-1])
    qf = q.reshape(-1, 1, q.shape[-1], 1).float()
    logits = torch.cat([segments[:, s] @ qf[:, 0] for s in range(kt * kh)], dim=1)[..., 0]
    p = torch.softmax(logits * scale + logit_bias, dim=-1).to(value.dtype).float()
    vals = _tiles(value, kernel).float()
    acc = torch.zeros(vals.shape[0], vals.shape[-1], dtype=torch.float32, device=value.device)
    for j in range(vals.shape[1]):
        acc = acc + p[:, j:j + 1] * vals[:, j]
    return acc.reshape(q.shape[:3] + (value.shape[-1],)).to(q.dtype)


def _scalar(x: Union[float, Tensor], device: torch.device) -> Tuple[Optional[Tensor], float]:
    """A scale or bias for the C entry point: (fp32 device copy, 0.0) for a
    tensor on the card, converted there; (None, value) for a number or a CPU
    tensor, which passes by value."""
    if isinstance(x, Tensor) and x.device.type != "cpu":
        if x.numel() != 1 or x.device != device:
            raise ValueError(f"tile kernel: scale and bias are scalars on the inputs' device, got {x.shape} "
                             f"on {x.device}")
        return x.detach().to(torch.float32).reshape(1).contiguous(), 0.0
    return None, float(x)


def _operand(x: Tensor) -> Tensor:
    """Contiguous and 16-byte aligned, as the kernel's bulk copies read it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def fused_tile_attention(
    q: Tensor,  # (t1, h1, w1, qk): one query per tile
    key: Tensor,  # (t, h, w, qk)
    value: Tensor,  # (t, h, w, dv)
    kernel: tuple,  # (kt, kh, kw)
    scale: Union[float, Tensor],
    logit_bias: Union[float, Tensor] = 0.0,
) -> Tensor:
    """softmax(q·K_tileᵀ·scale + bias)·V_tile per (kt, kh, kw) tile."""
    plain_operands("K4", q, key, value, scale, logit_bias)
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
    if q.dtype not in TILE_DTYPES or any(x.dtype != q.dtype for x in (key, value)):
        raise TypeError(f"tile kernel takes bfloat16 or float32 q, key and value of one dtype; got {q.dtype}, "
                        f"{key.dtype}, {value.dtype}")
    if value.shape[:3] != key.shape[:3] or not takes_tile_kernel((t, h, w), qk, dv, kernel, q.dtype):
        raise ValueError(f"tile kernel: unsupported shapes {tuple(key.shape)}, dv {dv}, tile {tuple(kernel)}")
    if any(x.device != q.device for x in (key, value)):
        raise ValueError("tile kernel: all inputs must be on one device")
    q, key, value = _operand(q), _operand(key), _operand(value)
    (scale_t, scale_v), (bias_t, bias_v) = _scalar(scale, q.device), _scalar(logit_bias, q.device)
    out = torch.empty(q.shape[:3] + (dv,), dtype=q.dtype, device=q.device)
    fn = c_function("local_attn", "hicom_tile_attention", [ctypes.c_void_p] * 6 + [ctypes.c_float] * 2
                    + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    status = fn(q.data_ptr(), key.data_ptr(), value.data_ptr(), out.data_ptr(),
                scale_t.data_ptr() if scale_t is not None else None,
                bias_t.data_ptr() if bias_t is not None else None, scale_v, bias_v, t, h, w, qk, dv, kt, kh, kw,
                _sm_count(q.device.index or 0), int(q.dtype == torch.float32),
                torch.cuda.current_stream(q.device).cuda_stream)
    check(status, "hicom_tile_attention")
    fused_tile_attention.launches += 1
    return out


fused_tile_attention.launches = 0
