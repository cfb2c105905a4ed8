"""Video loading and frame sampling.

A copy of ``hicom_tpu/data/video.py`` (reference ``mm_utils.py:548-644``), with
cv2.VideoCapture or the native libav reader in place of decord (not available here): uniform
segment-midpoint sampling (or fps mode), optional start/end clipping, black-frame
padding up to ``num_frames``, MAX_FRAMES cap, pad-to-square, SigLIP preprocess.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import numpy as np
from PIL import Image

from ..constants import MAX_FRAMES, NUM_FRAMES, NUM_FRAMES_PER_SECOND
from .image import expand2square


def frame_sample(duration: int, mode: str = "uniform", num_frames: Optional[int] = None, fps=None) -> np.ndarray:
    if mode == "uniform":
        assert num_frames is not None, "num_frames required for uniform sampling"
        seg_size = float(duration - 1) / num_frames
        mids = [(seg_size * i + seg_size * (i + 1)) / 2 for i in range(num_frames)]
        return np.round(np.array(mids) + 1e-6).astype(int)
    if mode == "fps":
        assert fps is not None, "fps required for fps sampling"
        segment_len = min(fps // NUM_FRAMES_PER_SECOND, duration)
        return np.arange(segment_len // 2, duration, segment_len, dtype=int)
    raise ValueError(f"unsupported frame sampling mode: {mode}")


def _open_native(video_path: str):
    """Native libav reader (decord analogue, native/videoreader.cpp) when
    built; None → caller falls back to cv2. Cached per call site is
    unnecessary: open cost is one avformat header parse."""
    from .native_video import VideoReader, native_video_available

    if not native_video_available():
        return None
    try:
        return VideoReader(video_path)
    except IOError:
        # unreadable through libav: let cv2 produce its (possibly better)
        # error; a genuinely corrupt file raises loudly either way
        return None


def _read_frames_cv2(video_path: str, indices: List[int]) -> List[Image.Image]:
    import cv2

    cap = cv2.VideoCapture(video_path)
    wanted = sorted(set(int(i) for i in indices))
    frames_by_idx = {}
    pos = 0
    wi = 0
    while wi < len(wanted):
        target = wanted[wi]
        if target - pos > 30:  # long jump: seek
            cap.set(cv2.CAP_PROP_POS_FRAMES, target)
            pos = target
        ok, frame = cap.read()
        if not ok:
            break
        if pos == target:
            frames_by_idx[target] = Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            wi += 1
        pos += 1
    cap.release()
    if not frames_by_idx:
        raise IOError(f"failed to decode any frame from {video_path}")
    last = None
    out = []
    for i in indices:
        got = frames_by_idx.get(int(i), last)
        if got is None:
            got = next(iter(frames_by_idx.values()))
        out.append(got)
        last = got
    return out


def _video_meta_cv2(video_path: str):
    import cv2

    cap = cv2.VideoCapture(video_path)
    try:
        # cv2 never raises: a missing/corrupt file yields fps=0, frames=0 and
        # a cryptic IndexError downstream — fail loudly with the filename
        # (decord in the reference raised a clear error).
        if not cap.isOpened():
            raise IOError(f"cannot open video: {video_path}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if n <= 0:
            raise IOError(f"video has no decodable frames: {video_path}")
    finally:
        cap.release()
    return fps, n


def process_video(
    video_path: Union[str, np.ndarray, list],
    processor,
    s: Optional[float] = None,
    e: Optional[float] = None,
    aspect_ratio: str = "pad",
    num_frames: Optional[int] = NUM_FRAMES,
    max_frames: Optional[int] = None,
) -> np.ndarray:
    """→ (t, 3, H, W) float array of preprocessed frames.

    ``max_frames`` defaults to the reference's MAX_FRAMES=32 cap but may be
    raised for long-video configs (64+ frames; the compression keeps the
    token budget flat, so the TPU rebuild supports longer contexts than the
    reference — BASELINE.md config #5).
    """
    if isinstance(video_path, str):
        if s is not None and e is not None:
            s, e = max(s, 0.0), max(e, 0.0)
            if s > e:
                s, e = e, s
            elif s == e:
                e = s + 1

        if os.path.isdir(video_path):
            frame_files = sorted(os.listdir(video_path))
            fps, n_total = 3, len(frame_files)
            reader = "dir"
        elif video_path.endswith(".gif"):
            import imageio

            gif = imageio.get_reader(video_path)
            fps, n_total = 25, len(gif)
            reader = "gif"
        else:
            native = _open_native(video_path)
            if native is not None:
                fps, n_total = native.get_avg_fps(), len(native)
                reader = "native"
            else:
                fps, n_total = _video_meta_cv2(video_path)
                reader = "cv2"

        f_start = 0 if s is None else max(int(s * fps) - 1, 0)
        f_end = n_total - 1 if e is None else min(int(e * fps) - 1, n_total - 1)
        frame_indices = list(range(f_start, f_end + 1))
        duration = len(frame_indices)

        if num_frames is None:
            sampled = [frame_indices[i] for i in frame_sample(duration, mode="fps", fps=fps)]
        else:
            sampled = [frame_indices[i] for i in frame_sample(duration, mode="uniform", num_frames=num_frames)]

        if reader == "dir":
            video_data = [Image.open(os.path.join(video_path, frame_files[i])).convert("RGB") for i in sampled]
        elif reader == "gif":
            import cv2

            sampled_set = set(sampled)
            video_data = [
                Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_RGBA2RGB))
                for idx, frame in enumerate(gif)
                if idx in sampled_set
            ]
        elif reader == "native":
            with native:
                video_data = [Image.fromarray(f) for f in native.get_batch(sampled)]
        else:
            video_data = _read_frames_cv2(video_path, sampled)
    elif isinstance(video_path, np.ndarray):
        video_data = [Image.fromarray(f) for f in video_path]
    elif isinstance(video_path, list) and len(video_path) and isinstance(video_path[0], np.ndarray):
        video_data = [Image.fromarray(f) for f in video_path]
    elif isinstance(video_path, list) and len(video_path) and isinstance(video_path[0], str):
        video_data = [Image.open(f).convert("RGB") for f in video_path]
    elif isinstance(video_path, list) and len(video_path) and isinstance(video_path[0], Image.Image):
        video_data = list(video_path)
    else:
        raise ValueError(f"unsupported video input type: {type(video_path)}")

    while num_frames is not None and len(video_data) < num_frames:
        # a black frame of the last frame's size: PIL's size is (w, h), an array's shape (h, w, 3)
        w, h = video_data[-1].size
        video_data.append(Image.fromarray(np.zeros((h, w, 3), dtype=np.uint8)))

    cap = MAX_FRAMES if max_frames is None else max_frames
    if num_frames is not None:
        cap = max(cap, num_frames)  # an explicit frame budget overrides the cap
    video_data = video_data[:cap]

    if processor is None:
        # raw ingest: decoded uint8 frames only (t, h, w, 3); the caller
        # preprocesses them on the device (ops/preprocess.py), the pad to
        # square included, so pad bytes never cross the host link
        from ..ops.preprocess import stack_uint8_frames

        return stack_uint8_frames(video_data)
    if aspect_ratio == "pad" and not getattr(processor, "pads_to_square", False):
        mean255 = tuple(int(x * 255) for x in processor.image_mean)
        video_data = [expand2square(f, mean255) for f in video_data]
    return processor.preprocess(video_data)["pixel_values"]
