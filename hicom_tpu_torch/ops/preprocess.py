"""Frame preprocessing on the device: pad to square, bicubic resize, normalise.

Port of ``hicom_tpu/ops/preprocess.py``. The host only decodes and stacks
uint8 frames (:func:`stack_uint8_frames`); the centred pad with the mean
colour, PIL's separable bicubic resize (two fp32 products with PIL's filter
tables, ``out = Fy @ clip8(img @ Fx^T)``, each followed by PIL's uint8
``round(clip(x, 0, 255))``) and the rescale and normalisation run on the
model's device, so raw uint8 frames cross the host link instead of fp32
pixels and the pad bytes never do.

The two products feed a rounding to uint8 levels, so they run in full fp32
whatever the process's float32 matmul precision says (TF32 would move
pixels by a level); the switch is process-global while they run. The
filter tables are built on the host once per input ``(h, w)`` and device
and cached, so a call uploads only the frames (from pinned memory, without
waiting for the device).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def pil_bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) resampling matrix with PIL's BICUBIC
    coefficients (kernel a = -0.5; support scaled by the downscale factor =
    antialias), rows normalised to sum 1 (PIL's ImagingResampleHorizontal)."""

    def bicubic(x: np.ndarray) -> np.ndarray:
        a = -0.5
        x = np.abs(x)
        return np.where(
            x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
            np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))

    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    m = np.zeros((out_size, in_size), np.float32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = int(max(0.0, np.floor(center - support)))
        xmax = int(min(float(in_size), np.ceil(center + support)))
        idx = np.arange(xmin, xmax)
        w = bicubic((idx - center + 0.5) / filterscale)
        total = w.sum()
        if total != 0.0:
            w = w / total
        m[xx, xmin:xmax] = w.astype(np.float32)
    return m


def _clip8(x: Tensor) -> Tensor:
    """PIL's uint8 intermediate between the passes and of the final pixels."""
    return torch.round(torch.clamp(x, 0.0, 255.0))


@contextmanager
def _full_fp32():
    """Full fp32 products while inside (matmul precision ``"highest"``), the
    caller's precision (``"high"``, ``"medium"`` or ``"highest"``) restored
    after. The setting is process-global: a product another thread runs
    meanwhile is in full fp32 too."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to preprocess on the CPU")
    return device


def make_device_preprocess(
    h: int,
    w: int,
    out_size: int,
    image_mean: Sequence[float] = (0.5, 0.5, 0.5),
    image_std: Sequence[float] = (0.5, 0.5, 0.5),
    rescale_factor: float = 1 / 255,
    pad_square: bool = True,
    out_dtype=None,
    device="cuda",
):
    """``(t, h, w, 3) uint8 -> (t, 3, out, out)`` preprocess for one input
    geometry on ``device``. ``pad_square`` centres the frame on a square of
    side max(h, w) filled with the mean colour (``int(m * 255)``, the host
    path's ``expand2square`` colour). The result is fp32, or ``out_dtype``."""
    device = _device(device)
    if pad_square and h != w:
        side = max(h, w)
        off_y, off_x = (side - h) // 2, (side - w) // 2
        in_h = in_w = side
        bg = torch.tensor([int(m * 255) for m in image_mean], dtype=torch.float32).to(device)
    else:
        pad_square = False
        in_h, in_w = h, w
        off_y = off_x = 0
        bg = None
    fy = torch.from_numpy(pil_bicubic_matrix(in_h, out_size)).to(device)
    fx = torch.from_numpy(pil_bicubic_matrix(in_w, out_size)).to(device)
    mean = torch.tensor(image_mean, dtype=torch.float32).to(device)
    std = torch.tensor(image_std, dtype=torch.float32).to(device)

    def preprocess(frames: Tensor) -> Tensor:  # (t, h, w, 3) uint8 on ``device``
        x = frames.to(torch.float32)
        if pad_square:
            canvas = bg.expand(x.shape[0], in_h, in_w, 3).clone()
            canvas[:, off_y:off_y + h, off_x:off_x + w, :] = x
            x = canvas
        with _full_fp32():
            # horizontal then vertical pass, uint8-quantised between as PIL does
            x = _clip8(torch.einsum("thwc,ow->thoc", x, fx))
            x = _clip8(torch.einsum("thwc,oh->towc", x, fy))
        x = (x * rescale_factor - mean) / std
        x = x.permute(0, 3, 1, 2)  # (t, 3, out, out)
        return x.contiguous() if out_dtype is None else x.to(out_dtype).contiguous()

    return preprocess


def upload_frames(frames, device) -> Tensor:
    """A uint8 (t, h, w, 3) stack on ``device``: numpy or host tensors go
    through pinned memory with a copy that does not wait for the device."""
    device = torch.device(device)
    if isinstance(frames, Tensor) and frames.device.type == device.type:
        return frames.to(device)
    t = frames if isinstance(frames, Tensor) else torch.from_numpy(np.ascontiguousarray(frames))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DeviceSiglipPreprocessor:
    """Drop-in for ``data.processor.SiglipImagePreprocessor`` whose output is
    a tensor on ``device`` (the model's; default the CUDA device): the host
    only decodes and stacks uint8 frames. ``pads_to_square`` tells
    ``process_video`` to skip its host-side ``expand2square`` (the pad
    happens on the device). One pair of filter tables per input (h, w) and
    device, built on the first call and cached."""

    pads_to_square = True

    def __init__(
        self,
        image_mean: Sequence[float] = (0.5, 0.5, 0.5),
        image_std: Sequence[float] = (0.5, 0.5, 0.5),
        size: Tuple[int, int] = (384, 384),
        rescale_factor: float = 1 / 255,
        out_dtype=None,
        device="cuda",
    ):
        if size[0] != size[1]:
            raise ValueError("the device preprocess makes square outputs")
        self.image_mean = tuple(image_mean)
        self.image_std = tuple(image_std)
        self.size = tuple(size)
        self.rescale_factor = rescale_factor
        self.out_dtype = out_dtype
        self.device = _device(device)
        self.crop_size = {"height": size[0], "width": size[1]}
        self._fns = {}

    def _fn(self, h: int, w: int):
        key = (h, w, self.device)
        if key not in self._fns:
            self._fns[key] = make_device_preprocess(
                h, w, self.size[0], self.image_mean, self.image_std, self.rescale_factor, pad_square=True,
                out_dtype=self.out_dtype, device=self.device)
        return self._fns[key]

    def preprocess(self, images, return_tensors: str = "pt") -> dict:
        # a (t, h, w, 3) uint8 stack (raw ingest's output) as it is, else PIL images / frames
        stacked = isinstance(images, (Tensor, np.ndarray)) and images.ndim == 4
        frames = images if stacked else stack_uint8_frames(images)
        _, h, w, _ = frames.shape
        return {"pixel_values": self._fn(h, w)(upload_frames(frames, self.device))}

    def __call__(self, images, return_tensors: str = "pt"):
        return self.preprocess(images, return_tensors)


def stack_uint8_frames(images) -> np.ndarray:
    """PIL images / uint8 arrays (one size) -> a (t, h, w, 3) uint8 stack."""
    from PIL import Image

    arrs = []
    for img in images if isinstance(images, (list, tuple)) else [images]:
        if isinstance(img, Image.Image):
            if img.mode != "RGB":
                img = img.convert("RGB")
            arrs.append(np.asarray(img))
        else:
            a = np.asarray(img)
            if not (a.dtype == np.uint8 and a.ndim == 3 and a.shape[-1] == 3):
                raise ValueError(f"frames must be (h, w, 3) uint8, got {a.dtype} {a.shape}")
            arrs.append(a)
    if len({a.shape for a in arrs}) != 1:
        raise ValueError("frames of one video must share one size")
    return np.stack(arrs)
