"""Image loading: pad / anyres / highres / crop-split strategies.

A copy of ``hicom_tpu/data/image.py`` (numpy and PIL only), held to it exactly
by ``tests/test_torch_data.py``: aspect-ratio handling produces a stack of
square crops fed to the tower; ``anyres`` adds a grid of patches at the
best-fit pinpoint resolution plus a downscaled base image. The anyres helpers
are plain geometry and are copied whole; the training dataset refuses anyres
data until the anyres merge is ported.
"""

from __future__ import annotations

import ast
import math
import re
from typing import List, Sequence, Tuple, Union

import numpy as np
from PIL import Image


def load_image_from_base64(image: str) -> Image.Image:
    import base64
    from io import BytesIO

    return Image.open(BytesIO(base64.b64decode(image)))


def chunk_list(input_list, chunk_size):
    return [input_list[i : i + chunk_size] for i in range(0, len(input_list), chunk_size)]


def create_photo_grid(arr, rows=None, cols=None) -> np.ndarray:
    """Tile t frames into one grid image (reference mm_utils.py:157-204)."""
    if isinstance(arr, list):
        arr = np.stack([np.asarray(x) for x in arr])
    t, h, w, c = arr.shape
    if rows is None and cols is None:
        rows = math.ceil(math.sqrt(t))
        cols = math.ceil(t / rows)
    elif rows is None:
        rows = math.ceil(t / cols)
    elif cols is None:
        cols = math.ceil(t / rows)
    if rows * cols < t:
        raise ValueError(f"grid {rows}x{cols} cannot hold {t} frames")
    grid = np.zeros((h * rows, w * cols, c), dtype=arr.dtype)
    for i in range(t):
        r, cc = i // cols, i % cols
        grid[r * h : (r + 1) * h, cc * w : (cc + 1) * w] = arr[i]
    return grid


def expand2square(img: Image.Image, background_color) -> Image.Image:
    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    canvas = Image.new(img.mode, (side, side), background_color)
    canvas.paste(img, ((side - w) // 2, (side - h) // 2))
    return canvas


def select_best_resolution(original_size: Tuple[int, int], possible_resolutions) -> Tuple[int, int]:
    """Pick the pinpoint resolution maximizing effective pixels then minimizing waste."""
    ow, oh = original_size
    best, best_eff, best_waste = None, 0, float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (w, h), eff, waste
    return best


def resize_and_pad_image(img: Image.Image, target: Tuple[int, int]) -> Image.Image:
    ow, oh = img.size
    tw, th = target
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = img.resize((nw, nh))
    canvas = Image.new("RGB", (tw, th), (0, 0, 0))
    canvas.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return canvas


def divide_to_patches(img: Image.Image, patch_size: int) -> List[Image.Image]:
    patches = []
    w, h = img.size
    for top in range(0, h, patch_size):
        for left in range(0, w, patch_size):
            patches.append(img.crop((left, top, left + patch_size, top + patch_size)))
    return patches


def parse_grid_pinpoints(grid_pinpoints, patch_size: int) -> List[List[int]]:
    """Accepts "(1x1),...,(6x6)" range syntax or a literal list string."""
    if isinstance(grid_pinpoints, str) and "x" in grid_pinpoints:
        assert patch_size in (224, 336, 384, 448, 512), "unexpected patch_size"
        matches = re.findall(r"\((\d+)x(\d+)\)", grid_pinpoints)
        lo = tuple(map(int, matches[0]))
        hi = tuple(map(int, matches[-1]))
        grid = [(i, j) for i in range(lo[0], hi[0] + 1) for j in range(lo[1], hi[1] + 1)]
        return [[d * patch_size for d in pair] for pair in grid]
    if isinstance(grid_pinpoints, list):
        return grid_pinpoints
    return ast.literal_eval(grid_pinpoints)


def get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size: int) -> Tuple[int, int]:
    resolutions = parse_grid_pinpoints(grid_pinpoints, patch_size)
    w, h = select_best_resolution(image_size, resolutions)
    return w // patch_size, h // patch_size


def process_anyres_image(img: Image.Image, processor, grid_pinpoints) -> List[Image.Image]:
    if isinstance(processor.size, dict):
        shortest = processor.size.get("shortest_edge", processor.size.get("height"))
    else:
        shortest = min(processor.size)
    resolutions = parse_grid_pinpoints(grid_pinpoints, shortest)
    best = select_best_resolution(img.size, resolutions)
    padded = resize_and_pad_image(img, best)
    patches = divide_to_patches(padded, processor.crop_size["height"])
    base = img.resize((shortest, shortest))
    return [base] + patches


def extract_patches(img: Image.Image, patch_size: int, overlap_ratio: float) -> List[Image.Image]:
    W, H = img.size
    stride = int(patch_size * (1 - overlap_ratio))
    ny = (H - patch_size) // stride + 1
    nx = (W - patch_size) // stride + 1
    y0 = (H - (ny - 1) * stride - patch_size) // 2
    x0 = (W - (nx - 1) * stride - patch_size) // 2
    out = []
    for y in range(y0, y0 + ny * stride, stride):
        for x in range(x0, x0 + nx * stride, stride):
            out.append(img.crop((x, y, x + patch_size, y + patch_size)))
    return out


def process_highres_image(img: Image.Image, processor, grid_pinpoints) -> List[Image.Image]:
    grid_params = [int(x) for x in grid_pinpoints.split(",")]
    select_size = max(grid_params)
    if isinstance(processor.size, dict):
        shortest = processor.size.get("shortest_edge", processor.size.get("height"))
    else:
        shortest = min(processor.size)
    mean255 = tuple(int(x * 255) for x in processor.image_mean)
    padded = expand2square(img, mean255).resize((select_size, select_size))
    patches = extract_patches(padded, patch_size=shortest, overlap_ratio=0)
    return [img.resize((shortest, shortest))] + patches


def resize_and_center_crop(img: Image.Image, shortest: int) -> Image.Image:
    ar = img.width / img.height
    if ar > 1:
        nw, nh = int(shortest * ar), shortest
    else:
        nw, nh = shortest, int(shortest / ar)
    # reference uses Image.ANTIALIAS (= LANCZOS in modern PIL), mm_utils.py:476
    resized = img.resize((nw, nh), Image.LANCZOS)
    left, top = (nw - shortest) / 2, (nh - shortest) / 2
    return resized.crop((left, top, left + shortest, top + shortest))


def process_highres_image_crop_split(img, processor, crop_resolution, split_resolution):
    cropped = resize_and_center_crop(img, crop_resolution)
    return extract_patches(cropped, patch_size=split_resolution, overlap_ratio=0)


def process_image(
    image_paths: Union[str, Sequence[str]],
    processor,
    aspect_ratio: str = "pad",
    image_grid_pinpoints=None,
    image_crop_resolution=None,
    image_split_resolution=None,
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Load image(s) → ((n, 3, H, W) float array, original sizes)."""
    if isinstance(image_paths, str):
        image_paths = [image_paths]
    if len(image_paths) > 1:
        aspect_ratio = "pad"  # multi-image: simple pad

    images = [Image.open(p).convert("RGB") for p in image_paths]
    sizes = [im.size for im in images]

    if aspect_ratio == "highres":
        images = process_highres_image(images[0], processor, image_grid_pinpoints)
    elif aspect_ratio == "anyres" or (aspect_ratio and "anyres_max" in aspect_ratio):
        images = process_anyres_image(images[0], processor, image_grid_pinpoints)
    elif aspect_ratio == "crop_split":
        images = process_highres_image_crop_split(images[0], processor, image_crop_resolution, image_split_resolution)
    elif aspect_ratio == "pad":
        mean255 = tuple(int(x * 255) for x in processor.image_mean)
        images = [expand2square(im, mean255) for im in images]

    pixel_values = processor.preprocess(images)["pixel_values"]
    return pixel_values, sizes
