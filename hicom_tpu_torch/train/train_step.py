"""The train step: loss, gradients, clipped per-group AdamW update.

Port of ``hicom_tpu/train/train_step.py`` on one device. JAX computes a pure
step under ``jit`` over a sharded state; here :class:`TrainState` holds the
module and the optimizer, and a step updates them in place and returns the
same state. The freeze matrix is ``requires_grad`` (set by the optimizer's
``init``), so the loss needs no ``stop_gradient``: a tower with no trainable
parameter runs without a graph (``HIComModel.one_shot_forward``).

    model = build_model(cfg, device="cuda")
    opt = build_optimizer(model, learning_rate=1e-3, guide_injector_lr=1e-3,
                          tunable_parts="mm_projector", use_guide="direct")
    state = create_train_state(model, opt)      # on the CUDA device by default
    step = make_train_step()
    state, metrics = step(state, batch)         # loss, target_tokens, grad_norm
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np
import torch
from torch.nn import functional as F

from ..constants import IGNORE_INDEX
from .optimizer import GroupAdamW

Tensor = torch.Tensor


@dataclass
class TrainState:
    """The module (bf16 copies of the trainable parameters at full size, frozen
    weights), the optimizer (fp32 masters, moments) and the step count."""

    model: torch.nn.Module
    optimizer: GroupAdamW
    step: int = 0

    def params(self) -> Dict[str, Tensor]:
        """Every parameter by name: the fp32 master of a trainable one, the
        module's own tensor of a frozen one (the JAX ``state.params``)."""
        own = {n: p.detach() for n, p in self.model.named_parameters()}
        return {**own, **self.optimizer.masters}


def create_train_state(model: torch.nn.Module, optimizer: GroupAdamW, device=None) -> TrainState:
    """``model`` on ``device`` (the CUDA device unless given; raises without a
    card), frozen and with the optimizer's masters: the one-device counterpart
    of ``create_sharded_state``."""
    from ..api import resolve_device

    model.to(resolve_device(device))
    optimizer.init(model)
    return TrainState(model, optimizer, 0)


def causal_lm_loss(logits: Tensor, labels: Tensor):
    """Next-token cross entropy in fp32; positions labeled IGNORE_INDEX are
    masked. Returns (mean loss, number of target tokens)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    ll = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]), safe.reshape(-1),
                         reduction="none").reshape(safe.shape)
    n = valid.sum().clamp_min(1)
    return torch.where(valid, ll, torch.zeros_like(ll)).sum() / n, n


def make_loss_fn(model, modal: str = "video", has_frames: bool = True):
    """``loss_fn(batch) -> (loss, {"loss", "target_tokens"})`` over a batch of
    device tensors (``input_ids``, ``labels`` and optionally ``frames``,
    ``attention_mask``, ``guide_ids``, ``guide_mask``)."""

    def loss_fn(batch: Mapping[str, Tensor]):
        logits, labels, _ = model.one_shot_forward(
            batch["input_ids"], batch.get("frames") if has_frames else None,
            attention_mask=batch.get("attention_mask"), labels=batch["labels"],
            guide_ids=batch.get("guide_ids"), guide_mask=batch.get("guide_mask"), modal=modal)
        loss, n = causal_lm_loss(logits, labels)
        return loss, {"loss": loss.detach(), "target_tokens": n}

    return loss_fn


def batch_to_device(batch: Mapping, device: torch.device, dtype: torch.dtype) -> Dict[str, Tensor]:
    """numpy arrays or tensors -> tensors on ``device``; frames in the model's dtype."""
    out = {}
    for key, x in batch.items():
        x = torch.as_tensor(np.asarray(x)) if not isinstance(x, Tensor) else x
        out[key] = x.to(device, dtype=dtype if key == "frames" else None)
    return out


def make_train_step(modal: str = "video", has_frames: bool = True):
    """``train_step(state, batch) -> (state, metrics)``: forward, backward,
    one optimizer update. Metrics are device tensors: ``loss``,
    ``target_tokens`` and ``grad_norm`` (the unclipped global norm of the
    trainable gradients). A step leaves the gradients on the module until the
    next one starts. Multi-image and anyres batches wait for the
    multi-sentinel splice and the anyres plan (not ported yet)."""

    def train_step(state: TrainState, batch: Mapping):
        model = state.model
        weight = model.model.norm.weight
        batch = batch_to_device(batch, weight.device, weight.dtype)
        for p in model.parameters():
            p.grad = None
        loss, metrics = make_loss_fn(model, modal, has_frames)(batch)
        loss.backward()
        metrics["grad_norm"] = state.optimizer.update(model)
        state.step += 1
        return state, metrics

    return train_step
