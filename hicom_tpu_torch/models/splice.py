"""Fixed-shape multimodal embedding splice.

Port of ``hicom_tpu/models/splice.py``: one sentinel per row
(:func:`splice_visual_embeds`), or up to K, one per image of a multi-image
prompt (:func:`splice_visual_embeds_multi`). With ``p`` the
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


def splice_visual_embeds_multi(input_ids: Tensor, text_embeds: Tensor, visual_embeds: Tensor,
                               attention_mask: Optional[Tensor] = None, labels: Optional[Tensor] = None
                               ) -> SplicedInputs:
    """K sentinels per row (multi-image prompts, reference
    ``hicom_arch.py:309-322``): visual_embeds (b, K, V, D), the k-th sentinel
    of a row expanding into image k's V tokens. The output length is
    ``L + K * (V - 1)``; rows with fewer sentinels leave the surplus images
    out and pad at the tail, and a sentinel past the K-th is masked out.

    Input position j lands at ``j + (V - 1) * min(#sentinels before j, K)``;
    the k-th sentinel's V tokens start at its landing index."""
    b, L = input_ids.shape
    K, V = visual_embeds.shape[1:3]
    out_len = L + K * (V - 1)
    D = text_embeds.shape[-1]
    dev = input_ids.device
    if attention_mask is None:
        attention_mask = torch.ones((b, L), dtype=torch.bool, device=dev)
    attention_mask = attention_mask.to(torch.bool)

    modal = is_modal_token(input_ids)
    count = modal.to(torch.int64)
    prior = count.cumsum(dim=1) - count  # sentinels before j
    out_idx = torch.arange(L, device=dev)[None] + (V - 1) * prior.clamp_max(K)  # (b, L)
    keep = attention_mask & ~(modal & (prior >= K))
    rows = torch.arange(b, device=dev)[:, None].expand(b, L)

    # one spare slot at the end takes the absent images' writes, then goes
    embeds = text_embeds.new_zeros((b, out_len + 1, D))
    embeds[rows, out_idx] = text_embeds
    out_mask = torch.zeros((b, out_len + 1), dtype=torch.bool, device=dev)
    out_mask[rows, out_idx] = keep
    out_labels = None
    if labels is not None:
        out_labels = torch.full((b, out_len + 1), IGNORE_INDEX, dtype=labels.dtype, device=dev)
        out_labels[rows, out_idx] = torch.where(keep, labels, torch.full_like(labels, IGNORE_INDEX))

    # the k-th sentinel's input index: sentinels first, in order, by a stable sort of their keys
    pos = torch.arange(L, device=dev)[None].expand(b, L)
    order = torch.where(modal, pos, L + pos).argsort(dim=1)
    sent_out = out_idx.gather(1, order[:, :K])  # (b, K) landing index
    present = torch.arange(K, device=dev)[None] < modal.sum(dim=1, keepdim=True)  # (b, K)
    vis_idx = torch.where(present[..., None], sent_out[..., None] + torch.arange(V, device=dev), out_len)
    vrows = torch.arange(b, device=dev)[:, None, None].expand(b, K, V)
    embeds[vrows, vis_idx] = visual_embeds.to(embeds.dtype)
    out_mask[vrows, vis_idx] = True
    if out_labels is not None:
        out_labels[vrows, vis_idx] = IGNORE_INDEX

    embeds, out_mask = embeds[:, :out_len], out_mask[:, :out_len]
    out_labels = out_labels[:, :out_len] if out_labels is not None else None
    embeds = embeds * out_mask[..., None].to(embeds.dtype)
    positions = torch.arange(out_len, device=dev)[None].expand(b, out_len)
    return SplicedInputs(embeds, out_mask, out_labels, positions)
