"""Optimizer: the freeze matrix, the learning-rate groups and per-group AdamW.

Port of ``hicom_tpu/train/optimizer.py`` onto the port's state-dict names (the
reference's own, ``model.mm_projector.*``, ``model.vision_tower.*``):

* :func:`is_tunable` is the reference's ``mm_tunable_parts`` freeze matrix.
  The guide encoder sits under ``model.vision_tower.guide_encoder`` here and at
  the top level of the JAX tree, so it is told apart from the tower by name;
* :func:`lr_group` labels ``guide`` (the projector's guide injectors),
  ``projector``, ``vision`` (towers and guide encoder) and ``base``;
* :func:`decay_mask` is HF's rule: no decay on biases (any name whose last part
  contains "bias", which covers the logit-bias scalars) nor on norm weights
  (the JAX ``scale`` leaves);
* :class:`GroupAdamW` keeps the JAX package's master-weight policy
  (``param_dtype="float32"``): each trainable parameter has an fp32 master in
  the optimizer and the module's copy (bf16 at full size) is written back after
  every update; frozen parameters get ``requires_grad=False`` and no state.
  One clip by the global norm of the trainable gradients comes before the
  per-group AdamW updates, as ``optax.clip_by_global_norm`` does in the chain.
  With ``every_k`` > 1 it accumulates as ``optax.MultiSteps`` does (the JAX
  CLI's ``--gradient-accumulation-steps``): the running mean of k
  micro-batches' gradients, one clip and inner update per k calls, and the
  schedule counting inner updates.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..models.qwen2 import RMSNorm

Tensor = torch.Tensor
GROUPS = ("base", "projector", "guide", "vision")


def is_tunable(name: str, tunable_parts: str, use_guide: Optional[str] = None) -> bool:
    """Reference freeze matrix (``train.py:702-738``) on a state-dict name."""
    parts = [p.strip() for p in (tunable_parts or "").split(",") if p.strip()]
    guide_on = use_guide not in (None, "off")
    in_projector = "mm_projector" in name
    in_guide = "guide_encoder" in name
    in_tower = "vision_tower" in name and not in_guide
    is_scale = ("logit_scale" in name) or ("logit_bias" in name)

    if "mm_projector" in parts and in_projector and not is_scale:
        return True
    if "pure_vision_model" in parts and in_tower and "head" not in name:
        return True
    if guide_on:
        if "vision_model_head" in parts and in_tower and "head" in name:
            return True
        if "guide_encoder" in parts and in_guide:
            return True
        if "attn_scale" in parts and in_projector and is_scale:
            return True
    if "language_model" in parts and not in_tower and not in_projector and not in_guide:
        return True
    return False


def lr_group(name: str) -> str:
    """Reference LR grouping (``hicom_trainer.py:260-268``): keyword match on
    the state-dict name."""
    if "mm_projector" in name and "guide_injector" in name:
        return "guide"
    if "mm_projector" in name:
        return "projector"
    if "vision_tower" in name or "guide_encoder" in name:
        return "vision"
    return "base"


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: decayed}: every parameter but biases and norm weights."""
    norm_weights = {f"{mod_name}.{pn}" if mod_name else pn
                    for mod_name, mod in model.named_modules() if isinstance(mod, (nn.LayerNorm, RMSNorm))
                    for pn, _ in mod.named_parameters(recurse=False)}
    return {name: "bias" not in name.rsplit(".", 1)[-1] and name not in norm_weights
            for name, _ in model.named_parameters()}


def make_schedule(lr: float, total_steps: int, warmup_ratio: float = 0.03,
                  kind: str = "cosine") -> Callable[[int], float]:
    """The learning rate of update ``count`` (0 for the first), as the JAX
    package's optax schedule gives it: a linear warmup from 0 over
    ``int(total_steps * warmup_ratio)`` updates, then cosine decay to 0 at
    ``total_steps`` (or constant)."""
    warmup = int(total_steps * warmup_ratio)

    def ramp(count: int) -> float:  # optax.linear_schedule(0, lr, warmup)
        return lr * min(max(count, 0), warmup) / warmup if warmup > 0 else 0.0

    if kind == "constant":
        return (lambda count: lr) if warmup == 0 else (lambda count: ramp(count) if count < warmup else lr)
    decay_steps = max(total_steps, warmup + 1) - warmup

    def cosine(count: int) -> float:
        if count < warmup:
            return ramp(count)
        c = min(count - warmup, decay_steps)
        return lr * 0.5 * (1 + math.cos(math.pi * c / decay_steps))

    return cosine


class GroupAdamW:
    """Per-group AdamW over fp32 masters of the trainable parameters.

    Built by :func:`build_optimizer` from the labels alone; :meth:`init` then
    freezes the module and makes the masters and moments (the JAX
    ``optimizer.init``), and :meth:`update` takes one step from the gradients
    the module's parameters hold."""

    def __init__(self, labels: Dict[str, str], decay: Dict[str, bool], schedules: Dict[str, Callable[[int], float]],
                 *, weight_decay: float, b1: float, b2: float, eps: float, max_grad_norm: Optional[float],
                 every_k: int = 1):
        self.labels, self.decay, self.schedules = labels, decay, schedules
        self.weight_decay, self.betas, self.eps = weight_decay, (b1, b2), eps
        self.max_grad_norm = max_grad_norm
        self.every_k = every_k
        self.masters: Dict[str, Tensor] = {}
        self.adam: Optional[torch.optim.AdamW] = None
        self.count = 0  # updates taken; the schedule's argument
        self.mini_step = 0  # micro-batches accumulated towards the next update
        self.acc: Dict[str, Tensor] = {}

    def init(self, model: nn.Module) -> None:
        """Freeze what the labels freeze; fp32 masters and AdamW state for the rest."""
        params = dict(model.named_parameters())
        if set(params) != set(self.labels):
            raise ValueError("the optimizer was built for another model")
        for name, p in params.items():
            p.requires_grad_(self.labels[name] != "frozen")
        self.masters = {n: p.detach().float().clone() for n, p in params.items() if p.requires_grad}
        groups = []
        for group in GROUPS:
            for decayed in (True, False):
                ps = [m for n, m in self.masters.items() if self.labels[n] == group and self.decay[n] == decayed]
                if ps:
                    groups.append(dict(params=ps, lr=0.0, weight_decay=self.weight_decay if decayed else 0.0,
                                       lr_group=group))
        self.adam = torch.optim.AdamW(groups, betas=self.betas, eps=self.eps)
        self.count = self.mini_step = 0
        self.acc = {}

    @torch.no_grad()
    def update(self, model: nn.Module) -> Tensor:
        """Clip, step and write back (with ``every_k`` > 1: accumulate, and do
        so on every k-th call only); returns the unclipped global norm of this
        call's trainable gradients (a parameter without a gradient counts as
        zeros)."""
        params = dict(model.named_parameters())
        grads = {n: params[n].grad.float() if params[n].grad is not None else torch.zeros_like(m)
                 for n, m in self.masters.items()}
        norm = _global_norm(grads)
        if self.every_k > 1:
            k = self.mini_step
            self.acc = {n: g if k == 0 else self.acc[n] + (g - self.acc[n]) / (k + 1) for n, g in grads.items()}
            self.mini_step = (k + 1) % self.every_k
            if self.mini_step:
                return norm
            grads, self.acc = self.acc, {}
        clip_norm = norm if self.every_k == 1 else _global_norm(grads)
        for n, m in self.masters.items():
            g = grads.pop(n)  # the unclipped copy goes as its clipped one comes: one fp32 set at a time
            if self.max_grad_norm:
                g = torch.where(clip_norm < self.max_grad_norm, g, g / clip_norm * self.max_grad_norm)
            m.grad = g
        for group in self.adam.param_groups:
            group["lr"] = self.schedules[group["lr_group"]](self.count)
        self.adam.step()
        self.count += 1
        for n, m in self.masters.items():
            m.grad = None
            params[n].copy_(m)
        return norm

    def state_dict(self) -> dict:
        return {"masters": self.masters, "adam": self.adam.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict, model: nn.Module) -> None:
        """Restore masters, moments and count, and write the masters back into ``model``."""
        params = dict(model.named_parameters())
        with torch.no_grad():
            for n, m in self.masters.items():
                m.copy_(state["masters"][n])
                params[n].copy_(m)
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])
        self.mini_step, self.acc = int(state.get("mini_step", 0)), dict(state.get("acc", {}))


def _global_norm(grads: Dict[str, Tensor]) -> Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))


def build_optimizer(
    model: nn.Module,
    *,
    learning_rate: float,
    total_steps: int = 1000,
    warmup_ratio: float = 0.03,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    max_grad_norm: Optional[float] = 1.0,
    mm_projector_lr: Optional[float] = None,
    vision_tower_lr: Optional[float] = None,
    guide_injector_lr: Optional[float] = None,
    tunable_parts: str = "mm_projector,language_model",
    use_guide: Optional[str] = None,
    schedule_kind: str = "cosine",
    gradient_accumulation_steps: int = 1,
) -> GroupAdamW:
    """The JAX ``build_optimizer`` over ``model``'s parameter names, wrapped
    in ``optax.MultiSteps`` semantics when ``gradient_accumulation_steps`` > 1."""
    # reference fallback: guide lr set -> projector lr defaults to base lr
    if guide_injector_lr is not None and mm_projector_lr is None:
        mm_projector_lr = learning_rate
    group_lrs = {
        "base": learning_rate,
        "projector": mm_projector_lr if mm_projector_lr is not None else learning_rate,
        "guide": guide_injector_lr
        if guide_injector_lr is not None
        else (mm_projector_lr if mm_projector_lr is not None else learning_rate),
        "vision": vision_tower_lr if vision_tower_lr is not None else learning_rate,
    }
    labels = {n: lr_group(n) if is_tunable(n, tunable_parts, use_guide) else "frozen"
              for n, _ in model.named_parameters()}
    schedules = {g: make_schedule(lr, total_steps, warmup_ratio, schedule_kind) for g, lr in group_lrs.items()}
    return GroupAdamW(labels, decay_mask(model), schedules, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                      max_grad_norm=max_grad_norm, every_k=gradient_accumulation_steps)


def trainable_param_count(model: nn.Module, tunable_parts: str, use_guide: Optional[str] = None) -> int:
    return sum(p.numel() for n, p in model.named_parameters() if is_tunable(n, tunable_parts, use_guide))
