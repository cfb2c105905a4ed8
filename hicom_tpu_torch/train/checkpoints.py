"""Checkpoints: save/restore with a validity scan, and the projector-only export.

Port of ``hicom_tpu/train/checkpoints.py`` on one device. Orbax's atomic step
directories become one ``torch.save`` file per step,
``<output_dir>/checkpoints/<step>.pt``, written under a temporary name and
renamed into place, so a file with a step's name is always complete. A
checkpoint holds what a resume needs: the trainable parameters' fp32 masters,
the AdamW moments and counts by parameter name, and the step (frozen weights
come from the model's own source); a run saved with ``--offload-optimizer``
resumes without it and the other way round. :func:`export_mm_projector_bin` writes the reference's
``mm_projector.bin``.

A sharded state (``TrainState.mesh``) is saved in the same one-process
format: every rank takes part in gathering the whole tensors, one at a time
into rank 0's host memory, and rank 0 writes them; every rank maps the file
(``mmap``: the ranks of a node share its pages) and cuts its shards, one
tensor at a time. A run saved at one world size resumes at another, as orbax
resumes JAX's.
"""

from __future__ import annotations

import os
import re
from typing import Mapping, Optional

import torch

from ..utils import is_main_process, synchronize
from .train_step import TrainState

_STEP_FILE = re.compile(r"(\d+)\.pt")


def _ckpt_dir(output_dir: str) -> str:
    return os.path.join(os.path.abspath(output_dir), "checkpoints")


def save_checkpoint(output_dir: str, state: TrainState, step: Optional[int] = None, max_to_keep: int = 3) -> str:
    """Write ``state`` as step ``step`` (default ``state.step``) and keep the
    newest ``max_to_keep`` checkpoints; returns the file's path. Offloaded
    moments are read after the update's last copy to the host has landed
    (``GroupAdamW.state_dict``); the file is the same for both homes."""
    root = _ckpt_dir(output_dir)
    step = state.step if step is None else int(step)
    path = os.path.join(root, f"{step}.pt")
    payload = {"step": state.step, "optimizer": state.optimizer.state_dict()}  # gathered: every rank calls
    if is_main_process():
        os.makedirs(root, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        steps = sorted(_steps(root))
        for old in steps[:max(0, len(steps) - max_to_keep)]:
            os.remove(os.path.join(root, f"{old}.pt"))
    synchronize()
    return path


def _steps(root: str):
    return [int(m.group(1)) for m in map(_STEP_FILE.fullmatch, os.listdir(root)) if m]


def latest_valid_step(output_dir: str) -> Optional[int]:
    """Latest complete checkpoint step, deleting what an interrupted save left
    (reference ``is_ckpt_valid``/``check_ckpt_exists``, utils.py:63-100): a
    temporary file, or an empty step file, is removed so a resume never reads
    a truncated checkpoint."""
    root = _ckpt_dir(output_dir)
    if not os.path.isdir(root):
        return None
    if is_main_process():  # rank 0 alone deletes
        for name in os.listdir(root):
            path = os.path.join(root, name)
            if name.endswith(".tmp") or (_STEP_FILE.fullmatch(name) and os.path.getsize(path) == 0):
                os.remove(path)
    synchronize()
    steps = _steps(root)
    return max(steps) if steps else None


def restore_checkpoint(output_dir: str, state: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
    """Load step ``step`` (default: the latest valid one) into ``state`` in
    place: masters, moments, counts and step, with the module's copies
    rewritten from the masters. Returns the state, or None when there is no
    checkpoint."""
    if step is None:
        step = latest_valid_step(output_dir)
    if step is None:
        return None
    # mapped on the host: each tensor's master (or shard) goes to the device, its moments back to their home
    payload = torch.load(os.path.join(_ckpt_dir(output_dir), f"{step}.pt"), map_location="cpu", weights_only=True,
                         mmap=True)
    state.optimizer.load_state_dict(payload["optimizer"], state.model)
    state.step = int(payload["step"])
    return state


def export_mm_projector_bin(params: Mapping[str, torch.Tensor], path: str) -> None:
    """Write the projector as the reference's ``mm_projector.bin``: an fp16
    state dict under ``model.mm_projector.*`` keys (hicom_trainer.py:98-111),
    plus ``model.image_newline`` where the model has one. ``params`` maps
    state-dict names to tensors (``TrainState.params()``: fp32 masters of the
    trained parameters)."""
    sd = {k: v.detach().float().cpu().half() for k, v in params.items()
          if k.startswith("model.mm_projector.") or k == "model.image_newline"}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(sd, path)
