"""Where training state rests.

Port of ``hicom_tpu/parallel/sharding.py``. This first part is the host
offload of the optimizer state, the counterpart of ``supports_host_offload``
and ``host_offload_shardings`` (``hicom_tpu/parallel/sharding.py:106-132``):
JAX gives the optimizer-state subtree a ``pinned_host`` memory kind and XLA
streams it around each update; here the optimizer's flat fp32 state is held
in host pieces that its update walk copies in and out
(``train/optimizer.py``).

PyTorch's pinned (caching host) allocator rounds a request up to the next
power of two, so a moment pinned as one tensor can take nearly twice its
bytes (a 2.18 GB embedding moment takes 4.29 GB). The pieces here are a
power of two each, and only the last piece of a buffer is rounded.
"""

from __future__ import annotations

from typing import List

import torch


def supports_host_offload(device) -> bool:
    """Whether ``device`` can take its optimizer state from host memory: a
    CUDA device copies it from pinned memory asynchronously; a CPU's tensors
    are host memory already."""
    device = torch.device(device)
    return device.type == "cpu" or (device.type == "cuda" and torch.cuda.is_available())


def host_pieces(numel: int, piece: int, device) -> List[torch.Tensor]:
    """Zeroed fp32 host memory for a flat buffer of ``numel`` elements that
    ``device`` reads, in pieces of ``piece`` elements (a power of two; the
    last piece holds the rest). For a CUDA device the pieces are pinned, and
    a failed pin raises: nothing falls back to pageable or device memory."""
    if piece <= 0 or piece & (piece - 1):
        raise ValueError(f"a host piece must be a power of two elements, not {piece}")
    device = torch.device(device)
    if not supports_host_offload(device):
        raise ValueError(f"{device} cannot take its optimizer state from host memory")
    pin = device.type == "cuda"
    pieces = []
    for start in range(0, numel, piece):
        t = torch.empty(min(piece, numel - start), dtype=torch.float32, pin_memory=pin)
        if pin and not t.is_pinned():
            raise RuntimeError("pinned host memory was not granted")
        pieces.append(t.zero_())
    return pieces


def pinned_bytes() -> int:
    """Bytes of pinned host memory handed out by PyTorch's host allocator now
    (its blocks as rounded; cached free blocks not counted)."""
    return int(torch.cuda.host_memory_stats()["active_bytes.current"])
