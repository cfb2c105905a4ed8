"""Fixed-shape multimodal embedding splice (one sentinel per row).

Port of ``hicom_tpu/models/splice.py:splice_visual_embeds``. With ``p`` the
sentinel position and V the visual token count:

    out[j] = text[j]            for j <  p
    out[j] = visual[j - p]      for p <= j < p + V
    out[j] = text[j - V + 1]    for j >= p + V

The output length is always ``L - 1 + V``; rows without a sentinel keep their
text and pad at the tail, as the reference's right padding does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import IGNORE_INDEX, MODAL_INDEX_MAP

Tensor = torch.Tensor

_MODAL_IDS = tuple(MODAL_INDEX_MAP.values())


class SplicedInputs(NamedTuple):
    embeds: Tensor  # (b, L-1+V, D)
    attention_mask: Tensor  # (b, L-1+V) bool
    labels: Optional[Tensor]  # (b, L-1+V) or None
    positions: Tensor  # (b, L-1+V) int64


def is_modal_token(input_ids: Tensor) -> Tensor:
    m = torch.zeros(input_ids.shape, dtype=torch.bool, device=input_ids.device)
    for tok in _MODAL_IDS:
        m |= input_ids == tok
    return m


def splice_visual_embeds(input_ids: Tensor, text_embeds: Tensor, visual_embeds: Tensor,
                         attention_mask: Optional[Tensor] = None, labels: Optional[Tensor] = None
                         ) -> SplicedInputs:
    b, L = input_ids.shape
    V = visual_embeds.shape[1]
    out_len = L - 1 + V
    dev = input_ids.device

    modal = is_modal_token(input_ids)
    has_mm = modal.any(dim=1)
    p = torch.where(has_mm, modal.to(torch.int64).argmax(dim=1), torch.full_like(has_mm, L, dtype=torch.int64))
    if attention_mask is None:
        attention_mask = torch.ones((b, L), dtype=torch.bool, device=dev)
    attention_mask = attention_mask.to(torch.bool)

    j = torch.arange(out_len, device=dev)[None, :]
    p_ = p[:, None]
    in_text_head = j < p_
    in_visual = (j >= p_) & (j < p_ + V)
    idx_text = torch.where(in_text_head, j, j - V + 1).clamp(0, L - 1)
    idx_vis = (j - p_).clamp(0, V - 1)

    D = text_embeds.shape[-1]
    gathered_text = torch.gather(text_embeds, 1, idx_text[..., None].expand(b, out_len, D))
    gathered_vis = torch.gather(visual_embeds, 1, idx_vis[..., None].expand(b, out_len, D))
    embeds = torch.where(in_visual[..., None], gathered_vis.to(text_embeds.dtype), gathered_text)

    text_mask = torch.gather(attention_mask, 1, idx_text)
    valid_tail = torch.where(has_mm[:, None], torch.ones_like(j, dtype=torch.bool), j < L)
    out_mask = torch.where(in_visual, torch.ones_like(text_mask), text_mask) & valid_tail
    embeds = embeds * out_mask[..., None].to(embeds.dtype)

    out_labels = None
    if labels is not None:
        text_labels = torch.gather(labels, 1, idx_text)
        out_labels = torch.where(in_visual | ~out_mask, torch.full_like(text_labels, IGNORE_INDEX), text_labels)
    positions = torch.arange(out_len, device=dev)[None].expand(b, out_len)
    return SplicedInputs(embeds, out_mask, out_labels, positions)
