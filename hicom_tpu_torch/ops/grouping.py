"""Spatiotemporal tile grouping for the local compressor.

Port of ``hicom_tpu/ops/grouping.py``: a (t, h, w, d) volume is cut into
kernel-sized tiles; an axis that does not divide falls back to overlapping
windows, with the window starts clamped in bounds (``docs/DESIGN.md``, Known
divergences). Layout ``((t1 h1 w1), (t2 h2 w2), d)``. Leading batch axes pass
through, so the projector's batch dimension needs no loop.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

Tensor = torch.Tensor


def overlap_window_starts(n: int, kernel: int) -> np.ndarray:
    """Start index of each window along an axis of length n."""
    if kernel <= 0:
        raise ValueError("kernel must be positive")
    if n % kernel == 0:
        return np.arange(0, n, kernel)
    num_windows = math.ceil(n / kernel)
    no_repeat = n % num_windows
    if no_repeat == 0:
        no_repeat = num_windows
    starts = []
    start = 0
    for i in range(num_windows):
        step = kernel if i < no_repeat else kernel - 1
        end = start + step
        starts.append(end - kernel)
        start = end
    return np.clip(np.asarray(starts), 0, n - kernel)


def window_indices(n: int, kernel: int) -> np.ndarray:
    """(num_windows, kernel) absolute indices along one axis."""
    starts = overlap_window_starts(n, kernel)
    return starts[:, None] + np.arange(kernel)[None, :]


def _gather_indices(n: int, kernel: int) -> np.ndarray:
    """:func:`window_indices` as JAX's gather reads them: an axis shorter than
    its kernel gives negative indices, which count from the end (``i + n``)
    and are then clamped into the axis."""
    idx = window_indices(n, kernel)
    return np.clip(np.where(idx < 0, idx + n, idx), 0, n - 1)


def tile_thw(x: Tensor, kernel: Sequence[int]) -> Tensor:
    """Group (..., t, h, w, d) volumes into (..., (t1 h1 w1), (t2 h2 w2), d) tiles."""
    *lead, t, h, w, d = x.shape
    kt, kh, kw = kernel
    it = torch.as_tensor(_gather_indices(t, kt), device=x.device)  # (t1, kt)
    ih = torch.as_tensor(_gather_indices(h, kh), device=x.device)
    iw = torch.as_tensor(_gather_indices(w, kw), device=x.device)
    t1, h1, w1 = it.shape[0], ih.shape[0], iw.shape[0]
    n = len(lead)
    x = x.index_select(n, it.reshape(-1)).reshape(*lead, t1, kt, h, w, d)
    x = x.index_select(n + 2, ih.reshape(-1)).reshape(*lead, t1, kt, h1, kh, w, d)
    x = x.index_select(n + 4, iw.reshape(-1)).reshape(*lead, t1, kt, h1, kh, w1, kw, d)
    perm = list(range(n)) + [n + i for i in (0, 2, 4, 1, 3, 5, 6)]  # t1 h1 w1 t2 h2 w2 d
    return x.permute(perm).reshape(*lead, t1 * h1 * w1, kt * kh * kw, d)

