"""Tracing / profiling helpers.

Port of ``hicom_tpu/profiling.py``: ``trace`` records a ``torch.profiler``
trace (CPU, and CUDA when there is a card) and writes it to ``log_dir`` as a
Chrome trace, viewable in Perfetto or TensorBoard; ``annotate`` names a region
of it; ``device_time`` times a function as the JAX package's does, with CUDA
events when its inputs are on the card and the host clock otherwise;
``StepTimer`` is the JAX package's text.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace: ``with profiling.trace("/tmp/trace") as prof: step(...)``.
    On exit ``log_dir`` holds ``<worker>.<time>.pt.trace.json``; ``prof`` also
    gives ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named region inside a trace (shows up on the timeline)."""
    return torch.profiler.record_function(name)


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def device_time(fn, *args, iters: int = 1, chain: int = 1, feedback=None, **kwargs) -> float:
    """Seconds per call of ``fn(*args, **kwargs)``, over ``iters`` runs of a
    chain of ``chain`` calls after one warm-up chain.

    Each call's first output tensor is summed into a float32 accumulator, and
    the next call's inputs depend on the last one's: by default every floating
    point tensor argument gets 1e-6 added (a full read and write of the inputs
    per call, which inflates a fast op with big inputs); pass
    ``feedback(out, args) -> args`` to route the output back into the inputs
    instead, e.g. ``lambda o, a: (o,) + a[1:]``. When an argument lies on a
    CUDA device the time is read from CUDA events recorded around the runs,
    else from the host clock; either way the accumulator is read back once
    at the end.
    """

    def prog(a):
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(chain):
            out = fn(*a, **kwargs)
            acc = acc + _leaves(out)[0].float().sum()
            if feedback is not None:
                a = feedback(out, a)
            else:
                a = tuple(x + torch.tensor(1e-6, dtype=x.dtype, device=x.device)
                          if isinstance(x, torch.Tensor) and x.is_floating_point() else x for x in a)
        return acc

    tensors = _leaves(list(args))
    device = next((t.device for t in tensors if t.device.type == "cuda"), torch.device("cpu"))
    float(prog(args))  # warm-up
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        acc = sum(prog(args) for _ in range(iters))
        end.record()
        float(acc)
        return start.elapsed_time(end) / 1e3 / (iters * chain)
    t0 = time.perf_counter()
    acc = sum(prog(args) for _ in range(iters))
    float(acc)
    return (time.perf_counter() - t0) / (iters * chain)


class StepTimer:
    """Rolling it/s + device-step seconds for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._times = self._times[-self.window:]
        self._last = now
        return self.rate

    @property
    def rate(self) -> Optional[float]:
        if not self._times:
            return None
        return len(self._times) / sum(self._times)
