"""Separable linear interpolation matching ``F.interpolate(align_corners=False)``.

Port of ``hicom_tpu/ops/resize.py``: half-pixel-centred sampling without
antialiasing, one gather + lerp per axis, computed in the input's dtype exactly
as the JAX version does (so both packages round alike); and the anyres
merge's 2x2 max pool.
"""

from __future__ import annotations

from typing import Sequence

import torch

Tensor = torch.Tensor


def _linear_resize_axis(x: Tensor, axis: int, out_size: int) -> Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    scale = in_size / out_size
    # align_corners=False: src = (dst + 0.5) * scale - 0.5, clamped to >= 0
    dst = torch.arange(out_size, dtype=torch.float32, device=x.device)
    src = ((dst + 0.5) * scale - 0.5).clamp_min(0.0)
    lo = src.floor().to(torch.int64).clamp(0, in_size - 1)
    hi = (lo + 1).clamp(0, in_size - 1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w_hi = (src - lo.to(torch.float32)).to(x.dtype).reshape(shape)
    x_lo = x.index_select(axis, lo)
    x_hi = x.index_select(axis, hi)
    return x_lo + (x_hi - x_lo) * w_hi


def interpolate_linear(x: Tensor, axes: Sequence[int], out_sizes: Sequence[int]) -> Tensor:
    """N-linear interpolation over ``axes`` to ``out_sizes``."""
    if len(axes) != len(out_sizes):
        raise ValueError("one output size per axis")
    for axis, size in zip(axes, out_sizes):
        x = _linear_resize_axis(x, axis, size)
    return x


def resize_thw(x: Tensor, out_thw: Sequence[int]) -> Tensor:
    """Trilinear resize of (..., t, h, w, d) volumes over their t, h, w axes."""
    n = x.ndim
    return interpolate_linear(x, (n - 4, n - 3, n - 2), tuple(out_thw))


def max_pool2d(x: Tensor, window: int = 2) -> Tensor:
    """Max pool with stride == window over the (h, w) axes of (..., h, w, d)
    volumes: trailing remainder rows and columns are dropped, and the window's
    identity is -inf, as ``jax.lax.reduce_window`` gives it in the JAX package."""
    *lead, h, w, d = x.shape
    ho, wo = h // window, w // window
    x = x[..., : ho * window, : wo * window, :].reshape(*lead, ho, window, wo, window, d)
    return x.amax(dim=(-4, -2))
