"""Visual-feature token layout: flattening and newline insertion, batched.

Port of ``hicom_tpu/models/postprocess.py`` with a leading batch axis: a
(b, t, h, w, d) compressed volume becomes (b, V, d) tokens, with the learned
``image_newline`` spliced per row / frame / sequence as ``mm_patch_merge_type``
and ``mm_newline_position`` ask.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def _flat(x: Tensor) -> Tensor:
    b, t, h, w, d = x.shape
    return x.reshape(b, t * h * w, d)


def post_process_visual_feature(config, visual_feature: Tensor, modal: str,
                                image_newline: Optional[Tensor], is_anyres: bool) -> Tensor:
    merge_type = getattr(config, "mm_patch_merge_type", "flat") or "flat"
    newline_pos = getattr(config, "mm_newline_position", "one_token") or "one_token"
    if not merge_type.startswith("spatial"):
        return _flat(visual_feature)

    b, t, h, w, d = visual_feature.shape
    nl = image_newline.to(visual_feature.dtype) if image_newline is not None else None
    if modal == "video":
        if newline_pos == "grid":
            x = torch.cat([visual_feature, nl.expand(b, t, h, 1, d)], dim=3)
            return x.reshape(b, t * h * (w + 1), d)
        if newline_pos == "frame":
            x = torch.cat([visual_feature.reshape(b, t, h * w, d), nl.expand(b, t, 1, d)], dim=2)
            return x.reshape(b, t * (h * w + 1), d)
        if newline_pos == "one_token":
            return torch.cat([_flat(visual_feature), nl.expand(b, 1, d)], dim=1)
        if newline_pos == "no_token":
            return _flat(visual_feature)
        raise ValueError(f"Unexpected mm_newline_position: {newline_pos}")
    if modal == "image":
        if t != 1:
            raise ValueError("image features must have t == 1")
        if is_anyres:
            x = torch.cat([visual_feature, nl.expand(b, 1, h, 1, d)], dim=3)
            return x.reshape(b, h * (w + 1), d)
        if nl is not None:
            return torch.cat([_flat(visual_feature), nl.expand(b, 1, d)], dim=1)
    return _flat(visual_feature)


def num_visual_tokens(config, thw, modal: str, is_anyres: bool = False, has_newline: bool = None) -> int:
    """Token count produced by :func:`post_process_visual_feature` per sample."""
    t, h, w = thw
    merge_type = getattr(config, "mm_patch_merge_type", "flat") or "flat"
    newline_pos = getattr(config, "mm_newline_position", "one_token") or "one_token"
    if has_newline is None:
        has_newline = "anyres" in (getattr(config, "image_aspect_ratio", "") or "")
    if not merge_type.startswith("spatial"):
        return t * h * w
    if modal == "video":
        return {
            "grid": t * h * (w + 1),
            "frame": t * (h * w + 1),
            "one_token": t * h * w + 1,
            "no_token": t * h * w,
        }[newline_pos]
    if modal == "image":
        if is_anyres:
            return h * (w + 1)
        return h * w + (1 if has_newline else 0)
    return t * h * w
