"""Weights in the reference (HF) layout: from the JAX package's parameters, and from disk.

The port's modules carry the reference state-dict names, so three sources load
through one ``load_state_dict(strict=True)``:

* :func:`state_dict_from_jax`: the JAX package's parameter tree (nested dicts
  of arrays, as ``hicom_tpu``'s ``HIComModel.init`` makes them), by its own copy
  of the JAX package's export rules: Dense kernels transposed, conv kernels
  HWIO -> OIHW, ``scale`` -> ``weight``, ``embedding`` -> ``weight``,
  ``layers_i`` -> ``layers.i``;
* :func:`load_hf_state_dict`: an exported ``model.safetensors`` or a real SFT
  checkpoint (single file or sharded), read by the port's own safetensors
  reader (:func:`load_safetensors`; no ``safetensors`` package needed);
* :func:`model_state_dict`: either of those filtered to what a model holds
  (a real SigLIP checkpoint also carries the pooling head's probe attention,
  which nothing uses).

Quantized JAX trees carry over too: ``kernel_q`` / ``kernel_nf4`` /
``kernel_scale`` become ``weight_q`` / ``weight_nf4`` / ``weight_scale`` in
the (out, ...) orientation, and ``act_scale``, ``act_smooth`` and the towers'
``qkv_quant`` keep their names (``models/quant.py``).

The pieces of the other layouts: :func:`tower_state` (a SigLIP or CLIP
tower directory), :func:`convert_projector_state` (``mm_projector.bin``),
:func:`load_torch_bin`, and LoRA's: :func:`load_peft_adapter` and
:func:`apply_lora` (the merge at load); and the trainer's exports,
:func:`export_hf_checkpoint` (fp16 safetensors + ``config.json``, written by
the port's own :func:`save_safetensors`) and :func:`export_peft_adapter`.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_TOWER_EXACT = {
    "token_embedding": "embeddings.token_embedding.weight",
    "position_embedding": "embeddings.position_embedding.weight",
}


# the JAX quantized linears' leaves (models/quant.py) and their port names
_QUANT_LEAVES = {"kernel_q": "weight_q", "kernel_nf4": "weight_nf4", "kernel_scale": "weight_scale"}


def flax_to_torch_state(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a flax parameter subtree into torch-style keys."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, parts):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, parts + [str(key)])
            return
        leaf, name = parts[-1], ".".join(parts[:-1])
        arr = np.asarray(node)
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            out[f"{prefix}{name}.weight"] = np.ascontiguousarray(arr)
        elif leaf in _QUANT_LEAVES:  # quantized linears: (in, out) layouts transposed
            out[f"{prefix}{name}.{_QUANT_LEAVES[leaf]}"] = np.ascontiguousarray(arr.T)
        elif leaf in ("scale", "embedding"):
            out[f"{prefix}{name}.weight"] = arr
        elif leaf == "bias":
            out[f"{prefix}{name}.bias"] = arr
        else:
            out[f"{prefix}{name}.{leaf}" if name else f"{prefix}{leaf}"] = arr

    walk(tree, [])
    return out


def _tower_keys(sd: Dict[str, np.ndarray], is_text: bool) -> Dict[str, np.ndarray]:
    root = "text_model" if is_text else "vision_model"
    host = "guide_encoder" if is_text else "vision_tower"
    out = {}
    for k, v in sd.items():
        k = _TOWER_EXACT.get(k, k)
        k = re.sub(r"encoder\.layers_(\d+)\.", r"encoder.layers.\1.", k)
        if k.startswith("patch_embedding."):
            k = "embeddings." + k
        k = k.replace("head_layernorm.", "head.layernorm.").replace("head_mlp.", "head.mlp.")
        out[f"model.vision_tower.{host}.{root}.{k}"] = v
    return out


_CLIP_ATTN = ("q_proj.", "k_proj.", "v_proj.", "out_proj.")


def _clip_tower_keys(sd: Dict[str, np.ndarray], is_text: bool) -> Dict[str, np.ndarray]:
    """The JAX CLIP modules' flat names (``layers_i.q_proj``, ``class_embedding``)
    -> HF ``CLIP*ModelWithProjection`` names under the port's hosts (the JAX
    export's ``fix_clip_tower_keys``)."""
    root = "text_model" if is_text else "vision_model"
    host = "guide_encoder" if is_text else "vision_tower"
    out = {}
    for k, v in sd.items():
        if k in ("visual_projection.weight", "text_projection.weight"):
            out[f"model.vision_tower.{host}.{k}"] = v
            continue
        if k == "class_embedding":
            k = "embeddings.class_embedding"
        elif k in ("position_embedding", "token_embedding"):
            k = f"embeddings.{k}.weight"
        elif k.startswith("patch_embedding."):
            k = "embeddings." + k
        m = re.match(r"layers_(\d+)\.(.+)", k)
        if m:
            mid = "self_attn." if m.group(2).startswith(_CLIP_ATTN) else ""
            k = f"encoder.layers.{m.group(1)}.{mid}{m.group(2)}"
        out[f"model.vision_tower.{host}.{root}.{k}"] = v
    return out


def _jax_tower_keys(tree: Mapping, is_text: bool) -> Dict[str, np.ndarray]:
    """A JAX tower subtree under the port's names: SigLIP trees nest their
    layers under ``encoder``, CLIP trees hold ``layers_i`` at the top."""
    flat = flax_to_torch_state(tree)
    return _tower_keys(flat, is_text) if "encoder" in tree else _clip_tower_keys(flat, is_text)


def state_dict_from_jax(params: Mapping, config=None) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter tree -> this package's state dict.

    ``params`` holds any of ``language_model``, ``vision_tower``,
    ``guide_encoder``, ``mm_projector`` and ``image_newline``, with SigLIP or
    CLIP towers and a hicom or mean-pool projector. ``config`` is accepted
    for symmetry with the JAX export and not needed: the names alone decide
    the layout.
    """
    sd: Dict[str, np.ndarray] = {}
    if "language_model" in params:
        for k, v in flax_to_torch_state(params["language_model"]).items():
            sd[re.sub(r"model\.layers_(\d+)\.", r"model.layers.\1.", k)] = v
    if "vision_tower" in params:
        sd.update(_jax_tower_keys(params["vision_tower"], is_text=False))
    if "guide_encoder" in params:
        sd.update(_jax_tower_keys(params["guide_encoder"], is_text=True))
    if "mm_projector" in params:
        sd.update({f"model.{k}": v for k, v in flax_to_torch_state(params["mm_projector"], "mm_projector.").items()})
    if "image_newline" in params:
        sd["model.image_newline"] = np.asarray(params["image_newline"])
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str, metadata: Mapping[str, str] = None) -> None:
    """Write ``tensors`` in the safetensors layout: an 8-byte little-endian
    header length, a JSON header (dtype, shape and byte range of each tensor,
    padded with spaces to 8 bytes), then the little-endian buffers in header
    order. Tensors on any device are copied to the host."""
    header: Dict[str, dict] = {"__metadata__": dict(metadata)} if metadata else {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    os.replace(tmp, path)


def load_safetensors(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Read a safetensors file (the layout :func:`save_safetensors` writes)
    into tensors on ``device`` (default: host tensors viewing one buffer that
    holds the whole file)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(os.path.getsize(path) - 8 - n)
        f.readinto(data)
    header.pop("__metadata__", None)
    out = {}
    for name, meta in header.items():
        dtype = _ST_DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        flat = (torch.frombuffer(data, dtype=torch.uint8, count=end - begin, offset=begin) if end > begin
                else torch.empty(0, dtype=torch.uint8))
        t = flat.view(dtype).reshape(meta["shape"])
        out[name] = t.to(device) if device is not None else t
    return out


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.bin``/``.pt`` state dict on the host (tensors only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_hf_state_dict(model_path: str) -> Dict[str, torch.Tensor]:
    """All weights of an HF checkpoint directory: sharded or single
    safetensors, else sharded or single ``pytorch_model.bin``."""
    for index_name, load in (("model.safetensors.index.json", load_safetensors),
                             ("pytorch_model.bin.index.json", load_torch_bin)):
        index_path = os.path.join(model_path, index_name)
        if os.path.exists(index_path):
            with open(index_path) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            out: Dict[str, torch.Tensor] = {}
            for shard in shards:
                out.update(load(os.path.join(model_path, shard)))
            return out
    for name, load in (("model.safetensors", load_safetensors), ("pytorch_model.bin", load_torch_bin)):
        if os.path.exists(os.path.join(model_path, name)):
            return load(os.path.join(model_path, name))
    raise FileNotFoundError(f"no weights found under {model_path}")


def convert_projector_state(state_dict: Mapping[str, torch.Tensor], projector_kind: str = "hicom"
                            ) -> Dict[str, torch.Tensor]:
    """Projector weights under ``model.mm_projector.*``, from keys with that
    prefix, with ``mm_projector.``, with ``mm_projector`` nested deeper, or
    (when no key names the projector) already stripped: the rules of the JAX
    package's ``convert_projector_state``. A mean-pool projector
    (``projector_kind`` "mlp" or "linear") moves the reference's
    ``nn.Sequential`` keys (``0.weight``, ``2.weight``) under ``layers.``."""

    def name(key: str) -> str:
        if projector_kind in ("mlp", "linear") and re.match(r"^\d+\.", key):
            key = "layers." + key
        return "model.mm_projector." + key

    if not any("mm_projector" in k for k in state_dict):
        return {name(k): v for k, v in state_dict.items()}
    out = {}
    for key, v in state_dict.items():
        for prefix in ("model.mm_projector.", "mm_projector."):
            if key.startswith(prefix):
                out[name(key[len(prefix):])] = v
                break
        else:
            if "mm_projector" in key:
                out[name(key.split("mm_projector.")[-1])] = v
    return out


def export_hf_checkpoint(state_dict: Mapping[str, torch.Tensor], config, output_dir: str,
                         dtype: str = "float16") -> None:
    """Write a reference-layout SFT checkpoint: ``config.json`` and one
    ``model.safetensors`` with every floating tensor cast to ``dtype`` (fp16
    by default, as the JAX package writes it). ``state_dict`` holds the port's
    names (``model.state_dict()``, or ``TrainState.params()`` for the fp32
    masters of the trained parameters)."""
    os.makedirs(output_dir, exist_ok=True)
    dt = {"float16": torch.float16, "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    save_safetensors({k: v.to(dt) if v.is_floating_point() else v for k, v in state_dict.items()},
                     os.path.join(output_dir, "model.safetensors"))
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config.to_hf_dict(), f, indent=2)


# LoRA adapters: {module name: {"a": (in, r), "b": (r, out)}} (``train/lora.py``)
Adapters = Dict[str, Dict[str, torch.Tensor]]
# the peft config's targets: the decoder's linears
TARGET_MODULES = ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"]


def apply_lora(state_dict: Mapping[str, torch.Tensor], lora: Adapters, alpha: float = 16.0,
               rank: int = 8) -> Dict[str, torch.Tensor]:
    """A copy of ``state_dict`` with ``W + (alpha/rank) * (A @ B)^T`` at each
    adapted ``<module>.weight``, rounded to the weight's dtype; raises when an
    adapter names no weight."""
    scaling = alpha / rank
    out = dict(state_dict)
    missing = sorted(n for n in lora if f"{n}.weight" not in out)
    if missing:
        raise KeyError(f"{len(missing)} LoRA adapters match no weight, e.g. {missing[:3]}")
    for name, ab in lora.items():
        w = out[f"{name}.weight"]
        delta = (ab["a"].float() @ ab["b"].float()) * scaling
        out[f"{name}.weight"] = (w.float() + delta.T.to(w.device)).to(w.dtype)
    return out


def export_peft_adapter(lora: Adapters, path: str, alpha: float = 16.0, rank: int = 8) -> None:
    """Write the peft layout: ``adapter_model.bin`` (lora_A (r, in), lora_B
    (out, r), fp32) and ``adapter_config.json``."""
    sd = {}
    for name, ab in lora.items():
        sd[f"base_model.model.{name}.lora_A.weight"] = ab["a"].detach().float().cpu().T.contiguous()
        sd[f"base_model.model.{name}.lora_B.weight"] = ab["b"].detach().float().cpu().T.contiguous()
    os.makedirs(path, exist_ok=True)
    torch.save(sd, os.path.join(path, "adapter_model.bin"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": rank, "lora_alpha": alpha, "target_modules": TARGET_MODULES}, f)


def load_peft_adapter(path: str) -> Tuple[Adapters, float, int]:
    """Read a peft adapter directory: (adapters, alpha, rank)."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    sd = torch.load(os.path.join(path, "adapter_model.bin"), map_location="cpu", weights_only=True)
    lora: Adapters = {}
    for key, val in sd.items():
        m = re.match(r"base_model\.model\.(.*)\.lora_([AB])\.weight", key)
        if m:
            lora.setdefault(m.group(1), {})[m.group(2).lower()] = val.float().T.contiguous()
    return lora, float(cfg.get("lora_alpha", 16)), int(cfg.get("r", 8))


def decoder_state(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The decoder's weights of a checkpoint (no projector, tower or newline)."""
    return {k: v for k, v in sd.items()
            if not k.startswith(("model.mm_projector", "model.vision_tower", "model.image_newline"))}


def tower_state(sd: Mapping[str, torch.Tensor], guide: bool) -> Dict[str, torch.Tensor]:
    """A SigLIP or CLIP checkpoint's vision (and, with ``guide``, text)
    weights under the port's names. Takes HF ``SiglipModel`` /
    ``CLIPModel`` keys (``vision_model.*``, ``text_model.*``, CLIP's
    ``visual_projection`` / ``text_projection``) or the SFT nesting
    (``vision_tower.``, ``guide_encoder.`` before them); drops SigLIP's
    pooling-head probe attention, which nothing uses."""
    out = {}
    for key, v in sd.items():
        for prefix, host, wanted in (("vision_model.", "vision_tower", True), ("text_model.", "guide_encoder", guide),
                                     ("visual_projection.", "vision_tower", True),
                                     ("text_projection.", "guide_encoder", guide)):
            for nest in ("", f"{host}."):
                if key.startswith(nest + prefix) and wanted:
                    rest = key[len(nest + prefix):]
                    if not rest.startswith(("head.attention", "head.probe")):
                        out[f"model.vision_tower.{host}.{prefix}{rest}"] = v
    return out


def load_into(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Copy the tensors of ``sd`` that ``model`` holds into it, cast to each
    parameter's dtype (the rest of ``sd`` is ignored, as the JAX package's
    ``merge_params`` ignores it); raises on a shape mismatch."""
    own = model.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            if k in own:
                if tuple(v.shape) != tuple(own[k].shape):
                    raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(v.shape)} vs model "
                                     f"{tuple(own[k].shape)}")
                own[k].copy_(v)


def model_state_dict(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``sd`` restricted to the keys ``model`` holds, cast to each parameter's
    dtype; raises on a missing key or a shape mismatch."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} weights, e.g. {missing[:5]}")
    out = {}
    for k, p in own.items():
        v = sd[k]
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(v.shape)} vs model {tuple(p.shape)}")
        out[k] = v.to(p.dtype)
    return out
