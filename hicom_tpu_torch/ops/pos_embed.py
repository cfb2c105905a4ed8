"""3D additive sinusoidal position embedding for the global compressor.

Matches the reference construction (``upstream hicom/model/projector.py:57-101``):
per axis, ``angle(pos, i) = pos / 10000^(2*(i//2)/d)`` with sin at even feature
indices and cos at odd ones; the final embedding is the sum of the three
broadcast (t,d)+(h,d)+(w,d) tables. The axis tables are computed on the host
in float64 and cached, and copied to each device once, from pinned memory
without waiting; :func:`sincos_pos_embed_3d` sums them on the device, so a
32 x 27 x 27 x 1152 embedding is never built on the host and a forward copies
nothing from it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _axis_table(n: int, d_model: int) -> np.ndarray:
    pos = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(d_model, dtype=np.float64)[None, :]
    angles = pos / np.power(10000.0, (2 * (i // 2)) / np.float64(d_model))
    out = np.zeros_like(angles)
    out[:, 0::2] = np.sin(angles[:, 0::2])
    out[:, 1::2] = np.cos(angles[:, 1::2])
    return out.astype(np.float32)


def get_3d_sincos_pos_embed(t: int, h: int, w: int, d_model: int) -> np.ndarray:
    """(t, h, w, d_model) float32 additive sinusoidal embedding."""
    pt = _axis_table(t, d_model)[:, None, None, :]
    ph = _axis_table(h, d_model)[None, :, None, :]
    pw = _axis_table(w, d_model)[None, None, :, :]
    return pt + ph + pw


@functools.lru_cache(maxsize=16)
def _device_axis_table(n: int, d_model: int, device: torch.device) -> torch.Tensor:
    """:func:`_axis_table` on ``device``: a copy from pinned memory that does not block the host."""
    table = torch.from_numpy(_axis_table(n, d_model))
    if device.type == "cuda":
        return table.pin_memory().to(device, non_blocking=True)
    return table.to(device)


def sincos_pos_embed_3d(t: int, h: int, w: int, d_model: int, device) -> torch.Tensor:
    """:func:`get_3d_sincos_pos_embed` as a float32 tensor on ``device`` (same sums, same order)."""
    pt, ph, pw = (_device_axis_table(n, d_model, torch.device(device)) for n in (t, h, w))
    return pt[:, None, None, :] + ph[None, :, None, :] + pw[None, None, :, :]
