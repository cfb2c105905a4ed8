"""Host-side image preprocessing (resize → rescale → normalize).

Equivalent of the reference's ``ModifiedSiglipImageProcessor``
(reference ``model/encoder.py:31-68``), copied from ``hicom_tpu/data/processor.py``:
functional bicubic resize to
(384, 384) with no center crop, 1/255 rescale, mean/std normalize, channels
first. Vectorized with numpy over frame stacks (the reference maps Python
transforms per frame); PIL does the bicubic resample for bit-parity with
torchvision/transformers.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Union

import numpy as np
from PIL import Image


class SiglipImagePreprocessor:
    def __init__(
        self,
        image_mean: Sequence[float] = (0.5, 0.5, 0.5),
        image_std: Sequence[float] = (0.5, 0.5, 0.5),
        size=(384, 384),
        rescale_factor: float = 1 / 255,
        use_native: str = "auto",  # "auto" | "always" | "never"
    ):
        self.image_mean = tuple(image_mean)
        self.image_std = tuple(image_std)
        self.size = tuple(size)
        self.rescale_factor = rescale_factor
        self.use_native = use_native
        # reference CLIPImageProcessor compatibility
        self.crop_size = {"height": size[0], "width": size[1]}

    def _try_native(self, images) -> "np.ndarray | None":
        """Multithreaded C++ fast path when frames form one uint8 stack."""
        if self.use_native == "never" or self.size[0] != self.size[1]:
            return None
        from . import native

        if not native.native_available():
            return None
        arrs = []
        for img in images:
            if isinstance(img, Image.Image):
                if img.mode != "RGB":
                    img = img.convert("RGB")
                arrs.append(np.asarray(img))
            else:
                a = np.asarray(img)
                if a.dtype != np.uint8 or a.ndim != 3 or a.shape[-1] != 3:
                    return None
                arrs.append(a)
        if len({a.shape for a in arrs}) != 1:
            return None
        return native.preprocess_frames(
            np.stack(arrs), self.size[0], self.image_mean, self.image_std, self.rescale_factor
        )

    def _to_pil(self, image) -> Image.Image:
        if isinstance(image, Image.Image):
            return image.convert("RGB")
        return Image.fromarray(np.asarray(image).astype(np.uint8)).convert("RGB")

    def preprocess(self, images: Union[Image.Image, Iterable], return_tensors: str = "np") -> dict:
        if isinstance(images, Image.Image):
            images = [images]
        images = list(images)
        native_out = self._try_native(images)
        if native_out is not None:
            return {"pixel_values": native_out}
        arrs: List[np.ndarray] = []
        for img in images:
            pil = self._to_pil(img)
            if pil.size != (self.size[1], self.size[0]):
                pil = pil.resize((self.size[1], self.size[0]), Image.BICUBIC)
            arrs.append(np.asarray(pil, dtype=np.float32))
        x = np.stack(arrs)  # (t, H, W, 3)
        x = x * self.rescale_factor
        mean = np.asarray(self.image_mean, dtype=np.float32)
        std = np.asarray(self.image_std, dtype=np.float32)
        x = (x - mean) / std
        x = np.transpose(x, (0, 3, 1, 2))  # (t, 3, H, W)
        return {"pixel_values": x}

    def __call__(self, images, return_tensors="np"):
        return self.preprocess(images, return_tensors)
