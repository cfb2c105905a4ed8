"""LoRA adapters on the decoder's linears, and QLoRA over a quantized base.

Port of ``hicom_tpu/train/lora.py`` onto the port's module names. An adapter set is ``{module name: {"a": (in, r), "b": (r, out)}}``,
A drawn from N(0, 1/in) and B zeros, so a fresh adapter changes nothing (the
peft convention). Two forms compute with it:

* :class:`LoRA` (training): a module holding A and B as fp32 parameters,
  attached to the model by forward hooks that add the side path
  ``y = base(x) + (alpha/r) * (x @ A) @ B`` to each target linear, computed in
  the activations' dtype. The base weights stay frozen and untouched; under
  ``remat`` the hooks run again in each layer's recompute. This is the form
  the JAX package's ``lora_interceptor`` computes;
* :func:`apply_lora` (loading, in ``weights.py`` beside the other loaders and
  re-exported here): the merged weight ``W + (alpha/r) * A @ B``, rounded
  once to the weight's dtype, as the JAX ``apply_lora`` merges.

In fp32 the two agree to rounding (``tests/test_torch_lora.py``). In bf16 they
do not: a merged delta below half a bf16 ulp of its weight (at |W| = 0.02 the
ulp is 1.2e-4) is rounded away, so the first updates of a fresh adapter,
merged, change nothing; the side path adds them to the output at full size.
Loading merges once, after training, where the delta has grown.

QLoRA (:func:`make_qlora_loss_fn`, the CLI's ``--bits 4/8``) is the side
path over a decoder whose linears are ``QuantLinear`` (int8) or
``QuantLinear4`` (NF4): the base keeps its codes, dequantizes them for each
product and again in the backward (``models/quant.py``); the loss function's
adapter products run in its ``compute_dtype``, the trainer's in the
activations' dtype. :func:`estimate_qlora_memory` is the JAX
package's sizing arithmetic.

Adapters export to and load from the peft layout (``export_peft_adapter``,
``load_peft_adapter``, also in ``weights.py``): ``adapter_model.bin`` with
``base_model.model.<module>.lora_A.weight`` (r, in) and ``lora_B.weight``
(out, r) in fp32, beside ``adapter_config.json``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.quant import QuantLinear, QuantLinear4
from ..weights import TARGET_MODULES, Adapters, apply_lora, export_peft_adapter, load_peft_adapter  # noqa: F401

Tensor = torch.Tensor

# the peft default targets: the decoder's linears, never the projector, towers or embeddings
DEFAULT_TARGET = r"^model\.layers\.\d+\.(self_attn\.(q_proj|k_proj|v_proj|o_proj)|mlp\.(gate_proj|up_proj|down_proj))$"


def target_kernels(model: nn.Module, target_regex: str = DEFAULT_TARGET) -> Dict[str, Tuple[int, int]]:
    """{module name: (in_features, out_features)} of the linears LoRA attaches
    to: float linears, and the int8 / NF4 linears of a quantized base."""
    return {name: (m.in_features, m.out_features) for name, m in model.named_modules()
            if isinstance(m, (nn.Linear, QuantLinear, QuantLinear4)) and re.search(target_regex, name)}


def _device(module: nn.Module) -> torch.device:
    return next(iter(list(module.parameters()) + list(module.buffers()))).device


def init_lora_params(model: nn.Module, rank: int = 8, generator: Optional[torch.Generator] = None,
                     target_regex: str = DEFAULT_TARGET, dtype=torch.float32) -> Adapters:
    """Fresh adapters for every target, in sorted name order: A ~ N(0, 1/in)
    drawn from ``generator`` (default: a CPU generator seeded 0) on the
    generator's device and moved to the target's, B zeros."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    targets = target_kernels(model, target_regex)
    if not targets:
        raise ValueError("no LoRA target linear matched")
    modules = dict(model.named_modules())
    out = {}
    for name, (din, dout) in sorted(targets.items()):
        dev = _device(modules[name])
        a = torch.randn((din, rank), generator=gen, device=gen.device, dtype=dtype) / math.sqrt(din)
        out[name] = {"a": a.to(dev), "b": torch.zeros((rank, dout), dtype=dtype, device=dev)}
    return out


class LoRA(nn.Module):
    """Trainable adapters as a side path on the target linears of a model.

    ``attach(model)`` registers one forward hook per target; ``detach()``
    removes them. ``adapters()`` gives the current A and B by module name.
    The side path's products run in the activations' dtype."""

    compute_dtype = None  # QLoRA's side path sets its own (``make_qlora_loss_fn``)

    def __init__(self, lora: Adapters, alpha: float, rank: int):
        super().__init__()
        self.names = sorted(lora)
        self.scaling = alpha / rank
        self.a = nn.ParameterDict({_key(n): nn.Parameter(lora[n]["a"].detach().clone()) for n in self.names})
        self.b = nn.ParameterDict({_key(n): nn.Parameter(lora[n]["b"].detach().clone()) for n in self.names})
        self._handles = []

    def attach(self, model: nn.Module) -> "LoRA":
        modules = dict(model.named_modules())
        for name in self.names:
            a, b = self.a[_key(name)], self.b[_key(name)]
            self._handles.append(modules[name].register_forward_hook(self._side_path(a, b)))
        return self

    def _side_path(self, a: Tensor, b: Tensor):
        scaling, cd = self.scaling, self.compute_dtype

        def hook(module, inputs, output):
            x = inputs[0] if cd is None else inputs[0].to(cd)
            return output + (((x @ a.to(x.dtype)) @ b.to(x.dtype)) * scaling).to(output.dtype)

        return hook

    def detach(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def adapters(self) -> Adapters:
        return {n: {"a": self.a[_key(n)].detach(), "b": self.b[_key(n)].detach()} for n in self.names}


def make_qlora_loss_fn(base_loss_fn, model: nn.Module, alpha: float = 16.0, rank: int = 8,
                       compute_dtype=torch.bfloat16):
    """``loss_fn(lora, batch)`` over a frozen (typically quantized) ``model``:
    the :class:`Adapters` dict ``lora`` is attached as the side path for the
    call, its products in ``compute_dtype`` and its sum cast to each linear's
    output dtype, and never merged into the base; ``base_loss_fn(batch)``
    computes the loss of ``model`` (``train_step.make_loss_fn``). Gradients
    reach the adapters' tensors, which must require grad. Pass fp32 for an
    fp32 base so the two paths agree, as with the JAX ``make_qlora_loss_fn``."""

    def loss_fn(lora: Adapters, batch):
        module = _LiveLoRA(lora, alpha, rank, compute_dtype)
        module.attach(model)
        try:
            return base_loss_fn(batch)
        finally:
            module.detach()

    return loss_fn


class _LiveLoRA(LoRA):
    """A LoRA over the given tensors themselves (no copies), so their
    gradients are the loss's."""

    def __init__(self, lora: Adapters, alpha: float, rank: int, compute_dtype):
        nn.Module.__init__(self)
        self.names = sorted(lora)
        self.scaling = alpha / rank
        self.compute_dtype = compute_dtype
        self.a = {_key(n): lora[n]["a"] for n in self.names}
        self.b = {_key(n): lora[n]["b"] for n in self.names}
        self._handles = []


def estimate_qlora_memory(text_config, bits: int = 4, rank: int = 64, batch_tokens: int = 4096) -> Dict[str, float]:
    """Analytic device footprint (GiB) of QLoRA training at the decoder's
    dims, the JAX package's arithmetic: quantized linear weights with fp32
    scales, fp32 adapters and their two Adam moments, bf16 embeddings and
    head, and one layer's activations per token (remat). ``total_gib`` sums
    the ``*_gib`` entries."""
    tc = text_config
    d, ff = tc.hidden_size, tc.intermediate_size
    kv = tc.num_key_value_heads * tc.head_dim
    q = tc.num_attention_heads * tc.head_dim
    per_layer = d * q + 2 * d * kv + q * d + 3 * d * ff
    linear_params = tc.num_hidden_layers * per_layer
    embed_params = tc.vocab_size * d * (1 if tc.tie_word_embeddings else 2)
    wbytes = linear_params * (0.5 if bits == 4 else 1)
    if bits == 4:
        wbytes += linear_params / 64 * 4  # per-64-group scales
    else:
        wbytes += tc.num_hidden_layers * (q + 2 * kv + d + 3 * ff) * 4  # per-column scales
    n_targets = tc.num_hidden_layers * 7
    lora_params = sum(rank * (din + dout) for din, dout in
                      [(d, q), (d, kv), (d, kv), (q, d), (d, ff), (d, ff), (ff, d)]) * tc.num_hidden_layers
    act = batch_tokens * (4 * d + 2 * ff) * 2
    gib = 1024 ** 3
    out = {"weights_gib": wbytes / gib, "adapters_gib": lora_params * 4 / gib, "optimizer_gib": lora_params * 8 / gib,
           "embeds_gib": embed_params * 2 / gib, "activations_gib": act / gib, "n_lora_targets": n_targets}
    out["total_gib"] = sum(v for k, v in out.items() if k.endswith("_gib"))
    return out


def _key(name: str) -> str:
    return name.replace(".", "__")  # ParameterDict keys may not hold dots


def lora_from_jax(lora: Mapping[str, Mapping[str, np.ndarray]]) -> Adapters:
    """The JAX package's adapters (``language_model/model/layers_0/self_attn/
    q_proj/kernel`` paths) under the port's module names."""
    out = {}
    for path, ab in lora.items():
        name = path.replace("language_model/", "").replace("/kernel", "").replace("/", ".")
        name = re.sub(r"layers_(\d+)", r"layers.\1", name)
        out[name] = {k: torch.from_numpy(np.array(ab[k], dtype=np.float32)) for k in ("a", "b")}
    return out
