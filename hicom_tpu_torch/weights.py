"""Weights in the reference (HF) layout: from the JAX package's parameters, and from disk.

The port's modules carry the reference state-dict names, so three sources load
through one ``load_state_dict(strict=True)``:

* :func:`state_dict_from_jax`: the JAX package's parameter tree (nested dicts
  of arrays, as ``hicom_tpu``'s ``HIComModel.init`` makes them), by its own copy
  of the JAX package's export rules: Dense kernels transposed, conv kernels
  HWIO -> OIHW, ``scale`` -> ``weight``, ``embedding`` -> ``weight``,
  ``layers_i`` -> ``layers.i``;
* :func:`load_hf_state_dict`: an exported ``model.safetensors`` or a real SFT
  checkpoint (single file or sharded);
* :func:`model_state_dict`: either of those filtered to what a model holds
  (a real SigLIP checkpoint also carries the pooling head's probe attention,
  which nothing uses).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

_TOWER_EXACT = {
    "token_embedding": "embeddings.token_embedding.weight",
    "position_embedding": "embeddings.position_embedding.weight",
}


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


def state_dict_from_jax(params: Mapping, config=None) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter tree -> this package's state dict.

    ``params`` holds any of ``language_model``, ``vision_tower``,
    ``guide_encoder``, ``mm_projector`` and ``image_newline``. ``config`` is
    accepted for symmetry with the JAX export and not needed: the names alone
    decide the layout.
    """
    sd: Dict[str, np.ndarray] = {}
    if "language_model" in params:
        for k, v in flax_to_torch_state(params["language_model"]).items():
            sd[re.sub(r"model\.layers_(\d+)\.", r"model.layers.\1.", k)] = v
    if "vision_tower" in params:
        sd.update(_tower_keys(flax_to_torch_state(params["vision_tower"]), is_text=False))
    if "guide_encoder" in params:
        sd.update(_tower_keys(flax_to_torch_state(params["guide_encoder"]), is_text=True))
    if "mm_projector" in params:
        sd.update({f"model.{k}": v for k, v in flax_to_torch_state(params["mm_projector"], "mm_projector.").items()})
    if "image_newline" in params:
        sd["model.image_newline"] = np.asarray(params["image_newline"])
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def load_hf_state_dict(model_path: str) -> Dict[str, torch.Tensor]:
    """All weights of an HF checkpoint directory (sharded or single safetensors)."""
    from safetensors.torch import load_file as load_safetensors

    index_path = os.path.join(model_path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out: Dict[str, torch.Tensor] = {}
        for shard in shards:
            out.update(load_safetensors(os.path.join(model_path, shard)))
        return out
    single = os.path.join(model_path, "model.safetensors")
    if os.path.exists(single):
        return load_safetensors(single)
    raise FileNotFoundError(f"no safetensors weights under {model_path}")


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
