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

A LoRA step (:func:`create_lora_state`, :func:`make_lora_train_step`) trains
only the adapters of ``train/lora.py`` with their own AdamW over
``make_schedule``, the base model frozen whole, as the JAX CLI's
``--lora-enable`` loop does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping

import numpy as np
import torch
from torch.nn import functional as F

from ..constants import IGNORE_INDEX
from .lora import LoRA, Adapters
from .optimizer import GroupAdamW, make_schedule

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


def make_loss_fn(model, modal: str = "video", has_frames: bool = True, multi_image: bool = False,
                 anyres_plan=None):
    """``loss_fn(batch) -> (loss, {"loss", "target_tokens"})`` over a batch of
    device tensors (``input_ids``, ``labels`` and optionally ``frames``,
    ``attention_mask``, ``guide_ids``, ``guide_mask``). ``multi_image``:
    frames (b, K, 3, H, W) are K images per row; ``anyres_plan``: frames are
    each row's anyres crops, every row under this plan."""

    def loss_fn(batch: Mapping[str, Tensor]):
        logits, labels, _ = model.one_shot_forward(
            batch["input_ids"], batch.get("frames") if has_frames else None,
            attention_mask=batch.get("attention_mask"), labels=batch["labels"],
            guide_ids=batch.get("guide_ids"), guide_mask=batch.get("guide_mask"), modal=modal,
            multi_image=multi_image, anyres_plan=anyres_plan)
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


def make_train_step(modal: str = "video", has_frames: bool = True, multi_image: bool = False, anyres_plan=None):
    """``train_step(state, batch) -> (state, metrics)``: forward, backward,
    one optimizer update (or one accumulated micro-batch). Metrics are device
    tensors: ``loss``, ``target_tokens`` and ``grad_norm`` (the unclipped
    global norm of the trainable gradients). A step leaves the gradients on
    the module until the next one starts. The CLI keeps one step per (modal,
    multi_image, has_frames, anyres_plan), as the JAX CLI keys its compiled
    steps."""

    def train_step(state: TrainState, batch: Mapping):
        model = state.model
        weight = model.model.norm.weight
        batch = batch_to_device(batch, weight.device, weight.dtype)
        for p in model.parameters():
            p.grad = None
        loss, metrics = make_loss_fn(model, modal, has_frames, multi_image, anyres_plan)(batch)
        loss.backward()
        metrics["grad_norm"] = state.optimizer.update(model)
        state.step += 1
        return state, metrics

    return train_step


@dataclass
class LoraState:
    """A frozen model with LoRA adapters attached, their AdamW and schedule,
    and the count of updates taken (the schedule's argument)."""

    model: torch.nn.Module
    lora: LoRA
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    step: int = 0


def create_lora_state(model: torch.nn.Module, lora: Adapters, *, alpha: float, rank: int, learning_rate: float,
                      total_steps: int, warmup_ratio: float = 0.03, schedule_kind: str = "cosine",
                      weight_decay: float = 0.0, device=None) -> LoraState:
    """``model`` on ``device`` (the CUDA device unless given), every base
    parameter frozen, ``lora`` attached as trainable fp32 side paths with
    ``optax.adamw(make_schedule(...), weight_decay=...)``'s update: b1 0.9,
    b2 0.999, eps 1e-8, decay on every adapter, no clipping."""
    from ..api import resolve_device

    device = resolve_device(device)
    model.to(device)
    for p in model.parameters():
        p.requires_grad_(False)
    module = LoRA(lora, alpha, rank).to(device).attach(model)
    adam = torch.optim.AdamW(module.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    return LoraState(model, module, adam, make_schedule(learning_rate, total_steps, warmup_ratio, schedule_kind))


def make_lora_train_step(modal: str = "video", has_frames: bool = True, multi_image: bool = False,
                         anyres_plan=None):
    """``lora_step(state, batch) -> (state, metrics)``: the loss of the frozen
    model with the side paths, its gradient in the adapters only, one AdamW
    update. Metrics: ``loss`` and ``target_tokens`` (device tensors)."""

    def lora_step(state: LoraState, batch: Mapping):
        model = state.model
        weight = model.model.norm.weight
        batch = batch_to_device(batch, weight.device, weight.dtype)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = make_loss_fn(model, modal, has_frames, multi_image, anyres_plan)(batch)
        loss.backward()
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return lora_step
