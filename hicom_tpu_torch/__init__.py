"""hicom_tpu_torch: the PyTorch/CUDA port of hicom_tpu for NVIDIA Hopper (H100).

The JAX package ``hicom_tpu`` is the reference; this package imports nothing of
it (and never JAX). Plain tensor code is PyTorch; the four forward Pallas
kernels of the JAX package are hand-written CUDA kernels under ``csrc/``,
built with ``nvcc`` on first use, each with a plain PyTorch twin that CPU
tensors take.

    hc = hicom_tpu_torch.load_model(path)                 # on the CUDA device
    reply = hicom_tpu_torch.mm_infer(pixels, "What happens?", hc, tokenizer, modal="video")
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    HIComConfig,
    Qwen2Config,
    SiglipTextConfig,
    SiglipVisionConfig,
    parse_projector_type,
    tiny_test_config,
)


def load_model(model_path, **kwargs):
    from .api import load_model as _load

    return _load(model_path, **kwargs)


def model_init(model_path, **kwargs):
    from .api import model_init as _mi

    return _mi(model_path, **kwargs)


def build_model(config, **kwargs):
    from .api import build_model as _build

    return _build(config, **kwargs)


def mm_infer(image_or_video, instruct, model, tokenizer, modal="video", **kwargs):
    from .api import mm_infer as _infer

    return _infer(image_or_video, instruct, model, tokenizer, modal=modal, **kwargs)
