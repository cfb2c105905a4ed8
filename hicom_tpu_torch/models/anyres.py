"""Anyres image feature merging (multi-crop high-resolution images).

Port of ``hicom_tpu/models/anyres.py`` (the reference's
``process_anyres_image_feature``, ``hicom_arch.py:216-269``): crop 0 is the
base image, crops 1..n form an (nh, nw) grid at the best-fit pinpoint
resolution. Merge modes from ``mm_patch_merge_type``:

* ``maxpool2x2``: 2x2 max pool over the stitched grid;
* ``unpad``: the letterbox padding cut back out, and under ``anyres_max_N`` a
  bilinear downscale when the stitched grid exceeds N crops' worth of patches;
* otherwise: the plain stitch.

The geometry depends on the original image size, which is host metadata: the
plan is Python ints (:func:`make_anyres_plan`), so the merge reads no device
value. ``re`` is imported here: the reference's ``mm_utils`` forgot it, and
its range-syntax pinpoints raised a NameError that fell back to a 2x2 grid.
"""

from __future__ import annotations

import math
import re
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..data.image import get_anyres_image_grid_shape
from ..ops.resize import interpolate_linear, max_pool2d

Tensor = torch.Tensor


class AnyresPlan(NamedTuple):
    """The merge geometry of one anyres image; hashable, so train batches
    group by it (every row of a batch shares one plan)."""

    nh: int
    nw: int
    hw: int  # tower patches per side
    mode: str  # "maxpool2x2" | "unpad" | "stitch"
    unpad: Optional[Tuple[int, int, int, int]]  # (h0, h1, w0, w1) slice bounds
    down: Optional[Tuple[int, int]]  # post-unpad bilinear target (anyres_max)
    include_base: bool

    def merged_hw(self) -> Tuple[int, int]:
        H, W = self.nh * self.hw, self.nw * self.hw
        if self.mode == "maxpool2x2":
            return H // 2, W // 2
        if self.mode == "unpad":
            if self.down is not None:
                return self.down
            h0, h1, w0, w1 = self.unpad
            return h1 - h0, w1 - w0
        return H, W

    def token_count(self, has_newline: bool) -> int:
        """Visual tokens of the mean-pool path: the base (flat, plus a newline)
        and the merged patch rows, each with a newline column."""
        h, w = self.merged_hw()
        patch = h * (w + 1) if has_newline else h * w
        base = self.hw * self.hw + (1 if has_newline else 0) if self.include_base else 0
        return base + patch


def make_anyres_plan(image_size: Tuple[int, int], config, vision_tower_image_size: int,
                     hw: Optional[int] = None) -> Optional[AnyresPlan]:
    """The merge geometry for an image of original ``image_size`` (width,
    height); None when the merge type is not spatial (plain flat features)."""
    merge_type = getattr(config, "mm_patch_merge_type", "flat") or "flat"
    aspect = getattr(config, "image_aspect_ratio", "square") or "square"
    if not merge_type.startswith("spatial"):
        return None
    m = re.match(r"anyres_max_(\d+)", aspect) if "anyres_max" in aspect else None
    max_num_patches = int(m.group(1)) if m else None
    if not (aspect == "anyres" or "anyres_max" in aspect):
        raise ValueError(f"a spatial merge needs an anyres aspect ratio, not {aspect!r}")

    try:
        nw, nh = get_anyres_image_grid_shape(image_size, config.image_grid_pinpoints, vision_tower_image_size)
    except Exception:  # the reference's fallback grid
        nw, nh = 2, 2
    if hw is None:
        patch = getattr(getattr(config, "vision_config", None), "patch_size", 14)
        hw = vision_tower_image_size // patch

    include_base = "nobase" not in merge_type
    if "maxpool2x2" in merge_type:
        return AnyresPlan(nh, nw, hw, "maxpool2x2", None, None, include_base)
    if "unpad" in merge_type:
        hs, ws = unpad_bounds((nh * hw, nw * hw), image_size)
        down = None
        if max_num_patches is not None:
            h, w = hs.stop - hs.start, ws.stop - ws.start
            times = math.sqrt(h * w / (max_num_patches * hw**2))
            if times > 1.1:
                down = (int(h // times), int(w // times))
        return AnyresPlan(nh, nw, hw, "unpad", (hs.start, hs.stop, ws.start, ws.stop), down, include_base)
    return AnyresPlan(nh, nw, hw, "stitch", None, None, include_base)


def apply_anyres_plan(features: Tensor, plan: AnyresPlan) -> Dict[str, Optional[Tensor]]:
    """The merge under ``plan``: features (..., n, hw, hw, d) with crop 0 the
    base image -> {"base": (..., hw, hw, d) or None, "patch": (..., h, w, d)};
    leading axes (a batch of rows sharing the plan) are kept."""
    *lead, n, hw, _, d = features.shape
    base = features[..., 0, :, :, :] if plan.include_base else None
    grid = features[..., 1:, :, :, :].reshape(*lead, plan.nh, plan.nw, hw, hw, d)
    k = len(lead)
    stitched = grid.permute(*range(k), k, k + 2, k + 1, k + 3, k + 4).reshape(*lead, plan.nh * hw, plan.nw * hw, d)
    if plan.mode == "maxpool2x2":
        merged = max_pool2d(stitched, 2)
    elif plan.mode == "unpad":
        h0, h1, w0, w1 = plan.unpad
        merged = stitched[..., h0:h1, w0:w1, :]
        if plan.down is not None:
            merged = interpolate_linear(merged, (k, k + 1), plan.down)
    else:
        merged = stitched
    return {"base": base, "patch": merged}


def unpad_bounds(grid_hw: Tuple[int, int], original_size: Tuple[int, int]) -> Tuple[slice, slice]:
    """Slices that remove the letterbox padding (reference ``mm_utils.py:347-379``).

    grid_hw: the stitched feature map's (height, width); original_size: (width, height).
    """
    ow, oh = original_size
    ch, cw = grid_hw
    if ow / oh > cw / ch:
        new_h = int(oh * (cw / ow))
        pad = (ch - new_h) // 2
        return slice(pad, ch - pad), slice(0, cw)
    new_w = int(ow * (ch / oh))
    pad = (cw - new_w) // 2
    return slice(0, ch), slice(pad, cw - pad)


def process_anyres_image_feature(features: Tensor, image_size: Tuple[int, int], config,
                                 vision_tower_image_size: int) -> Union[Tensor, Dict[str, Optional[Tensor]]]:
    """features (n, hw, hw, d), crop 0 the base -> the merged dict, or the
    features as they are under a non-spatial merge."""
    plan = make_anyres_plan(image_size, config, vision_tower_image_size, hw=features.shape[1])
    if plan is None:
        return features
    return apply_anyres_plan(features, plan)
