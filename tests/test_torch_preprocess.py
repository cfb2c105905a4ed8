"""The device preprocessor, raw ingest and ``model_init`` against the JAX package.

On the CPU:

* ``pil_bicubic_matrix`` is bit-equal to JAX's (the same numpy);
* ``make_device_preprocess`` gives JAX's pixels for the release's 360x640
  frames, a square, a portrait and an upscale: equal, except at most 0.1% of
  pixels one uint8 level apart (the fp32 resize products sum in another
  order before PIL's rounding);
* ``DeviceSiglipPreprocessor`` through ``process_video`` and the raw-ingest
  branch (``processor=None``) give JAX's results;
* ``model_init(..., device_preprocess=True)`` + ``mm_infer`` on raw frames of
  a tiny exported checkpoint give JAX's string, with the processor's tensor
  taken as it is.
"""

import numpy as np
import pytest
import torch

from hicom_tpu.data.video import process_video as jax_process_video
from hicom_tpu.ops import preprocess as jpre
from hicom_tpu_torch.data.video import process_video
from hicom_tpu_torch.ops import preprocess as tpre

from test_torch_api import exported  # noqa: F401  (module fixture)

LEVEL = 2 / 255  # one uint8 level after (x / 255 - 0.5) / 0.5


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (t, h // 8 + 1, w // 8 + 1, 3)).astype(np.float32)
    smooth = np.repeat(np.repeat(base, 8, axis=1), 8, axis=2)[:, :h, :w]  # edges and flat areas
    return np.clip(smooth + rng.normal(0, 12, smooth.shape), 0, 255).astype(np.uint8)


def _assert_pixels(got, want):
    """Equal, or one uint8 level apart on at most 0.1% of the pixels."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    off = diff > 1e-6
    assert got.shape == want.shape
    assert diff.max() <= LEVEL * 1.001, diff.max()
    assert off.mean() <= 1e-3, off.mean()


@pytest.mark.parametrize("size", [(7, 13), (360, 640), (384, 384), (100, 200)])
def test_pil_bicubic_matrix_bit_equal(size):
    for i, o in ((size[0], 384), (size[1], 384), (max(size), 56)):
        assert np.array_equal(tpre.pil_bicubic_matrix(i, o), jpre.pil_bicubic_matrix(i, o))


@pytest.mark.parametrize("hw", [(360, 640), (384, 384), (480, 360), (100, 200)])
def test_device_preprocess_matches_jax(hw):
    import jax.numpy as jnp

    frames = _frames(2, *hw, seed=hw[0])
    want = np.asarray(jpre.make_device_preprocess(*hw, 384)(jnp.asarray(frames)))
    got = tpre.make_device_preprocess(*hw, 384, device="cpu")(torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _assert_pixels(got.numpy(), want)


@pytest.mark.parametrize("precision", ["medium", "high", "highest"])
def test_preprocess_restores_the_callers_matmul_precision(precision):
    frames = torch.from_numpy(_frames(1, 48, 64, seed=5))
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        tpre.make_device_preprocess(48, 64, 56, device="cpu")(frames)
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(saved)


def test_device_processor_through_process_video():
    video = _frames(6, 360, 640, seed=3)
    jproc = jpre.DeviceSiglipPreprocessor(size=(56, 56))
    want = np.asarray(jax_process_video(video, jproc, num_frames=4))
    proc = tpre.DeviceSiglipPreprocessor(size=(56, 56), device="cpu")
    got = process_video(video, proc, num_frames=4)
    assert isinstance(got, torch.Tensor) and got.shape == (6, 3, 56, 56)  # an array is taken whole
    _assert_pixels(got.numpy(), want)
    assert len(proc._fns) == 1  # one cached table pair per (h, w, device)
    process_video(video, proc, num_frames=4)
    assert len(proc._fns) == 1


def test_raw_ingest_matches_jax():
    video = _frames(5, 48, 64, seed=4)
    want = jax_process_video(video, None, num_frames=None)
    got = process_video(video, None, num_frames=None)
    assert got.dtype == np.uint8 and got.shape == (5, 48, 64, 3)
    assert np.array_equal(got, want)
    # a short video is padded with black frames up to num_frames (square
    # frames: both packages size the pad frame (w, h), ROADMAP Queue 3)
    square = _frames(5, 48, 48, seed=5)
    got = process_video(square, None, num_frames=8)
    assert got.shape == (8, 48, 48, 3) and np.array_equal(got, jax_process_video(square, None, num_frames=8))
    with pytest.raises(ValueError):
        tpre.stack_uint8_frames([np.zeros((4, 4, 3), np.float32)])


def test_model_init_mm_infer_on_raw_frames_matches_jax(exported):  # noqa: F811
    """ROADMAP Queue 1 item 2's acceptance: model_init with the device
    preprocessor, mm_infer on decoded uint8 frames, JAX's string."""
    import hicom_tpu
    from hicom_tpu_torch.api import model_init

    video = _frames(4, 30, 40, seed=2)
    gids = np.random.default_rng(3).integers(1, 10, (1, 16))
    kw = dict(guide_ids=gids, max_new_tokens=8)
    jhc, jproc, jtok = hicom_tpu.model_init(exported, device_preprocess=True, dtype="float32", cache_len=256)
    want = hicom_tpu.mm_infer(jproc["video"](video), "what is in the video ?", jhc, jtok, **kw)
    thc, proc, tok = model_init(exported, device_preprocess=True, dtype="float32", cache_len=256, device="cpu")
    assert isinstance(proc["video"].keywords["processor"], tpre.DeviceSiglipPreprocessor)
    pixels = proc["video"](video)
    assert isinstance(pixels, torch.Tensor) and pixels.dtype == torch.float32
    got = hicom_tpu_torch_mm_infer(pixels, tok, thc, kw)
    assert want and got == want


def hicom_tpu_torch_mm_infer(pixels, tok, thc, kw):
    from hicom_tpu_torch import mm_infer

    return mm_infer(pixels, "what is in the video ?", thc, tok, **kw)


def test_model_init_reads_the_env_switch(exported, monkeypatch):  # noqa: F811
    from hicom_tpu_torch.api import model_init

    monkeypatch.setenv("HICOM_DEVICE_PREPROCESS", "1")
    _, proc, _ = model_init(exported, dtype="float32", device="cpu")
    assert isinstance(proc["video"].keywords["processor"], tpre.DeviceSiglipPreprocessor)
    monkeypatch.setenv("HICOM_DEVICE_PREPROCESS", "0")
    _, proc, _ = model_init(exported, dtype="float32", device="cpu")
    assert not isinstance(proc["video"].keywords["processor"], tpre.DeviceSiglipPreprocessor)
