"""Sequence-parallel long-video encoding: a video's frames split across ranks.

Port of ``hicom_tpu/parallel/long_video.py``. The reference caps videos at 32
frames because all t x 729 SigLIP tokens must fit one device; here the t axis
is split over the ranks of a mesh instead:

* the SigLIP tower runs on each rank's chunk of frames (K1), with no
  collective;
* the local compressor (K4) is exact on the chunk when the chunk's length is
  a multiple of its temporal kernel: its query windows and tiles never cross
  a chunk's edge;
* the global compressor's queries attend over every rank's tokens: each rank
  runs K2 over its chunk without the merge, and the ranks all-gather the
  fp32 partials and merge them with the merge kernel (``ops/attention.sdpa(...,
  kv_group=)``); its 3D position embedding is the whole video's, sliced at
  the chunk's first frame.

The ranks then all-gather the local grids in rank order, and
``post_process_visual_feature`` runs once on the whole grid. Every rank calls
:func:`encode_visual_sharded` with the same frames and returns the same
tokens, those of ``HIComModel.encode_visual`` on the whole video.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..ops.attention import gather_rows
from .mesh import flat_group

Tensor = torch.Tensor


@torch.inference_mode()
def encode_visual_sharded(model, frames: Tensor, mesh=None, axis: Union[str, Sequence[str]] = ("dp", "fsdp", "tp"),
                          guide_embeds: Optional[Tensor] = None, modal: str = "video") -> Tensor:
    """Compress one long video, frames (t, 3, H, W) on this rank's device,
    with its t axis split over mesh axes ``axis`` (``mesh`` None: this
    process alone). ``guide_embeds`` (d,) or (Lg, d). Requires ``t % n == 0``
    and, with a local compressor, a chunk that is a multiple of its temporal
    kernel. Returns the (V, hidden) tokens of ``HIComModel.encode_visual`` on
    the whole video, on every rank. No gradient."""
    from ..models.postprocess import post_process_visual_feature

    cfg = model.hicom_config
    group, n, idx = flat_group(mesh, (axis,) if isinstance(axis, str) else tuple(axis))
    t = frames.shape[0]
    if t % n:
        raise ValueError(f"t={t} not divisible by {n} ranks")
    t_loc = t // n
    spec = cfg.projector
    if spec.local is not None and t_loc % spec.local.temporal_kernel_size:
        kt = spec.local.temporal_kernel_size
        raise ValueError(f"a rank's chunk of {t_loc} frames must be a multiple of the temporal kernel {kt}; "
                         f"sample t as a multiple of {n * kt}")
    ge = guide_embeds[None] if guide_embeds is not None else None
    local_raw, global_tokens = model.encode_visual_shard(frames[idx * t_loc:(idx + 1) * t_loc][None], ge, modal,
                                                         idx * t_loc, t, group)
    parts = []
    if local_raw is not None:
        grid = torch.cat(list(gather_rows(local_raw[0], group)), dim=0)  # the chunks' t' grids in rank order
        parts.append(post_process_visual_feature(cfg, grid[None], modal, model.model.image_newline, False)[0])
    if global_tokens is not None:
        parts.append(global_tokens[0])
    return torch.cat(parts, dim=-2) if len(parts) > 1 else parts[0]

