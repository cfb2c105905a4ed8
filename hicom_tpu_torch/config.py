"""Configuration of the PyTorch port (a stdlib-only copy of ``hicom_tpu.config``).

Structured, typed configs replace the reference's loose HF-config attribute bag.
The projector string DSL (``mm_projector_type`` values like ``local43_global32``,
``local43_adaptkv_global32``, ``mlp2x_gelu``) is parsed with the same semantics as
the reference parser (``upstream hicom/model/projector.py:231-304``) so that
published checkpoints reconstruct identically, but the result is an explicit
dataclass instead of string reinspection at every layer.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


# --------------------------------------------------------------------------- #
# Vision / text encoder configs
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class SiglipVisionConfig:
    """SigLIP ViT config (defaults = google/siglip-so400m-patch14-384)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"
    # remat checkpoints each encoder layer under grad mode; scan_layers exists
    # so configs round-trip with the JAX package (the port runs it False).
    # quantization: None or a serving mode of models/quant.TOWER_MODES.
    remat: bool = False
    scan_layers: bool = False
    quantization: Optional[str] = None

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side**2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class SiglipTextConfig:
    """SigLIP text encoder config (guide encoder; so400m defaults)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    vocab_size: int = 32000
    max_position_embeddings: int = 64
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"
    projection_size: int = 1152
    scan_layers: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP ViT config (defaults = openai/clip-vit-large-patch14-336)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    # remat as SiglipVisionConfig's; quantization stays None (the JAX
    # package quantizes SigLIP towers only)
    remat: bool = False
    quantization: Optional[str] = None

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side**2


@dataclass(frozen=True)
class ClipTextConfig:
    """CLIP text encoder config (guide encoder; clip-vit-large-patch14-336 defaults)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclass(frozen=True)
class Qwen2Config:
    """Qwen2/2.5 decoder config (defaults = Qwen2.5-7B-Instruct)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int = 128
    max_position_embeddings: int = 32768
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    attention_bias: bool = True  # Qwen2 uses QKV bias
    # Token ids (Qwen2.5-Instruct values)
    eos_token_id: int = 151645
    pad_token_id: int = 151643
    bos_token_id: int = 151643
    # quantization: None or a mode of models/quant.DECODER_MODES. Kept for
    # config round-trips with the JAX package: the port runs only
    # scan_layers=False, ring_axis=None. remat checkpoints each decoder layer
    # of a cache-less forward under grad mode.
    quantization: Optional[str] = None
    scan_layers: bool = False
    # int8 KV cache: k/v stored as int8 + per-slot absmax scales, read by the
    # decode kernel without a dequantized copy.
    kv_cache_int8: bool = False
    remat: bool = False
    ring_axis: Optional[str] = None


@dataclass(frozen=True)
class LlamaConfig:
    """Llama decoder config (defaults = Llama-2/vicuna-7B)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    eos_token_id: int = 2
    pad_token_id: int = 0
    bos_token_id: int = 1
    quantization: Optional[str] = None
    scan_layers: bool = False
    kv_cache_int8: bool = False
    remat: bool = False


def is_clip_tower(tower_path: Optional[str]) -> bool:
    """Whether ``mm_vision_tower`` names a CLIP tower (the JAX package's rule)."""
    return "clip" in (tower_path or "") and "siglip" not in (tower_path or "")


def _clip_tower_configs(tower_path: str):
    if not os.path.isdir(tower_path):
        return ClipVisionConfig(), ClipTextConfig()
    with open(os.path.join(tower_path, "config.json")) as f:
        d = json.load(f)
    vd, td = dict(d.get("vision_config", {})), dict(d.get("text_config", {}))
    if "projection_dim" in d:
        vd.setdefault("projection_dim", d["projection_dim"])
        td.setdefault("projection_dim", d["projection_dim"])
    vkeys = {f.name for f in dataclasses.fields(ClipVisionConfig)} - {"remat", "quantization"}
    tkeys = {f.name for f in dataclasses.fields(ClipTextConfig)}
    return (ClipVisionConfig(**{k: v for k, v in vd.items() if k in vkeys}),
            ClipTextConfig(**{k: v for k, v in td.items() if k in tkeys}))


def tower_configs(tower_path: str):
    """Vision/text configs from a local tower directory's config.json, else
    the defaults of a known tower name (SigLIP so400m, CLIP-L/336). A CLIP
    tower's compression keys live in its projection space: callers set
    ``HIComConfig.projector_qk_dim`` to :func:`projector_qk_dim` of the
    vision config (the JAX ``load_model``'s override)."""
    if is_clip_tower(tower_path):
        return _clip_tower_configs(tower_path)
    if os.path.isdir(tower_path):
        with open(os.path.join(tower_path, "config.json")) as f:
            d = json.load(f)
        vd = d.get("vision_config", d if d.get("model_type") == "siglip_vision_model" else {})
        td = d.get("text_config", {})
        vision = SiglipVisionConfig(
            hidden_size=vd.get("hidden_size", 1152),
            intermediate_size=vd.get("intermediate_size", 4304),
            num_hidden_layers=vd.get("num_hidden_layers", 27),
            num_attention_heads=vd.get("num_attention_heads", 16),
            image_size=vd.get("image_size", 384),
            patch_size=vd.get("patch_size", 14),
        )
        text = SiglipTextConfig(
            hidden_size=td.get("hidden_size", vision.hidden_size),
            intermediate_size=td.get("intermediate_size", vision.intermediate_size),
            num_hidden_layers=td.get("num_hidden_layers", vision.num_hidden_layers),
            num_attention_heads=td.get("num_attention_heads", vision.num_attention_heads),
            vocab_size=td.get("vocab_size", 32000),
            max_position_embeddings=td.get("max_position_embeddings", 64),
            projection_size=td.get("projection_size", td.get("hidden_size", vision.hidden_size)),
        )
        return vision, text
    if "siglip" in tower_path:
        return SiglipVisionConfig(), SiglipTextConfig()
    raise NotImplementedError(f"unknown vision tower: {tower_path}")


def projector_qk_dim(vision_config) -> Optional[int]:
    """The compression attention's key width a tower fixes: CLIP's projection
    dim (reference ``projector.py:410-411``); None (the hidden size) for SigLIP."""
    return getattr(vision_config, "projection_dim", None)


# --------------------------------------------------------------------------- #
# Projector DSL
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class LocalCompressorSpec:
    temporal_kernel_size: int = 4
    spatial_kernel_size: int = 3
    adapt_q: bool = False
    adapt_k: bool = False
    adapt_v: bool = False
    adapt_guide: bool = False
    # False → inherit the model-level use_guide; otherwise a mode string.
    force_use_guide: Any = False


@dataclass(frozen=True)
class GlobalCompressorSpec:
    num_queries: int = 32
    use_pos_emb: bool = True
    adapt_guide: bool = False
    force_use_guide: Any = False


@dataclass(frozen=True)
class ProjectorSpec:
    """Structured result of parsing ``mm_projector_type``."""

    kind: str  # "hicom" | "mlp" | "linear"
    mlp_depth: int = 2
    local: Optional[LocalCompressorSpec] = None
    global_: Optional[GlobalCompressorSpec] = None
    raw: str = ""


def _leading_int(s: str) -> str:
    digits = ""
    for ch in s:
        if ch.isdigit():
            digits += ch
        else:
            break
    return digits


def parse_projector_type(projector_type: str) -> ProjectorSpec:
    """Parse the reference projector DSL into a structured spec.

    Semantics mirror ``upstream hicom/model/projector.py:231-304``:

    * ``mlp<N>x_gelu``  → N-layer GELU MLP over mean-pooled features.
    * ``linear``        → single linear, mean-pool path.
    * otherwise substrings ``local<T><S>[adapt[qkvg]][guide<mode>]`` and
      ``global<N>[adaptg][guide<mode>]`` configure the two compressors.
      e.g. ``local43_global32`` → local(T=4, S=3) + global(N=32).
    """
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if m:
        return ProjectorSpec(kind="mlp", mlp_depth=int(m.group(1)), raw=projector_type)
    if projector_type == "linear":
        return ProjectorSpec(kind="linear", mlp_depth=1, raw=projector_type)

    local = None
    global_ = None
    if "local" in projector_type:
        phase = projector_type.split("local")[-1].split("global")[0]
        num = _leading_int(phase)
        if not (2 <= len(num) <= 3):
            raise ValueError(f"cannot parse local kernel sizes from {projector_type!r}")
        t_kernel = int(num[0])
        s_kernel = int(num[1:])
        adapt_q = adapt_k = adapt_v = adapt_g = False
        if "adapt" in phase:
            for ch in phase.split("adapt")[-1]:
                if ch == "q":
                    adapt_q = True
                elif ch == "k":
                    adapt_k = True
                elif ch == "v":
                    adapt_v = True
                elif ch == "g":
                    adapt_g = True
                else:
                    break
        force_guide: Any = False
        if "guide" in phase:
            force_guide = phase.split("guide")[-1].split("_")[0]
        local = LocalCompressorSpec(
            temporal_kernel_size=t_kernel,
            spatial_kernel_size=s_kernel,
            adapt_q=adapt_q,
            adapt_k=adapt_k,
            adapt_v=adapt_v,
            adapt_guide=adapt_g,
            force_use_guide=force_guide,
        )

    if "global" in projector_type:
        phase = projector_type.split("global")[-1].split("local")[0]
        num = _leading_int(phase)
        if not num:
            raise ValueError(f"cannot parse global query count from {projector_type!r}")
        force_guide = False
        if "guide" in phase:
            force_guide = phase.split("guide")[-1].split("_")[0]
        global_ = GlobalCompressorSpec(
            num_queries=int(num),
            use_pos_emb=True,
            adapt_guide="adaptg" in phase,
            force_use_guide=force_guide,
        )

    if local is None and global_ is None:
        raise ValueError(f"unknown projector type: {projector_type!r}")
    return ProjectorSpec(kind="hicom", local=local, global_=global_, raw=projector_type)


# Hard-wired tower geometry, as in the reference
# (upstream hicom/model/projector.py:407-414, 569-576).
_TOWER_GEOMETRY = {
    "siglip-so400m-patch14-384": dict(qk_dim=1152, hw=27),
    "clip-vit-large-patch14-336": dict(qk_dim=768, hw=24),
}


def tower_geometry(vision_tower_name: str) -> Tuple[int, int]:
    for key, geo in _TOWER_GEOMETRY.items():
        if key in vision_tower_name:
            return geo["qk_dim"], geo["hw"]
    raise NotImplementedError(f"unknown vision tower geometry: {vision_tower_name}")


# --------------------------------------------------------------------------- #
# Top-level model config
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class HIComConfig:
    """Full model configuration.

    Field names intentionally match the HF ``config.json`` keys the reference
    persists (``upstream hicom/train.py:664-746``) so released checkpoints
    round-trip losslessly through :meth:`from_hf_dict` / :meth:`to_hf_dict`.
    """

    model_type: str = "hicom_qwen2"  # or "hicom_llama"
    text_config: Any = field(default_factory=Qwen2Config)
    vision_config: SiglipVisionConfig = field(default_factory=SiglipVisionConfig)
    guide_text_config: SiglipTextConfig = field(default_factory=SiglipTextConfig)

    mm_vision_tower: str = "google/siglip-so400m-patch14-384"
    mm_projector_type: str = "local43_global32"
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"
    mm_patch_merge_type: str = "flat"
    mm_newline_position: str = "one_token"
    image_aspect_ratio: str = "pad"
    image_grid_pinpoints: Optional[str] = None
    use_guide: Optional[str] = None  # None/"off"/"direct"/"coarse"/"fine"
    use_clip_scale: str = ""  # comma list: "local", "global", "local,global"
    max_num_frames: int = 256
    num_frames: int = 8
    model_max_length: int = 4096
    # qk_dim of the compression attention: the dimension of the tower's
    # contrastive-head embeddings (SigLIP: hidden_size; CLIP: projection_dim).
    # None → derived from vision_config.hidden_size.
    projector_qk_dim: Optional[int] = None

    # dtype policy
    dtype: str = "bfloat16"  # compute/activation dtype
    param_dtype: str = "float32"  # master parameter dtype

    @property
    def hidden_size(self) -> int:
        return self.text_config.hidden_size

    @property
    def mm_hidden_size(self) -> int:
        return self.vision_config.hidden_size

    @property
    def projector(self) -> ProjectorSpec:
        return parse_projector_type(self.mm_projector_type)

    @property
    def qk_dim(self) -> int:
        if self.projector_qk_dim is not None:
            return self.projector_qk_dim
        return self.vision_config.hidden_size

    @property
    def vision_hw(self) -> int:
        return self.vision_config.num_patches_per_side

    def guide_enabled(self) -> bool:
        return self.use_guide not in (None, "off")

    def replace(self, **kw) -> "HIComConfig":
        return dataclasses.replace(self, **kw)

    # ---------------- HF config.json interop ---------------- #

    _MM_KEYS = (
        "mm_vision_tower",
        "mm_projector_type",
        "mm_vision_select_layer",
        "mm_vision_select_feature",
        "mm_patch_merge_type",
        "mm_newline_position",
        "image_aspect_ratio",
        "image_grid_pinpoints",
        "use_guide",
        "use_clip_scale",
        "max_num_frames",
        "num_frames",
        "model_max_length",
    )

    @classmethod
    def from_hf_dict(cls, d: dict) -> "HIComConfig":
        """Build from a reference checkpoint's ``config.json`` dict."""
        model_type = d.get("model_type", "hicom_qwen2")
        if "qwen2" in model_type:
            tc_cls = Qwen2Config
        elif "llama" in model_type or "vicuna" in model_type.lower():
            tc_cls = LlamaConfig
        else:
            raise ValueError(f"unsupported model_type: {model_type}")
        tc_fields = {f.name for f in dataclasses.fields(tc_cls)}
        tc_kwargs = {k: v for k, v in d.items() if k in tc_fields and v is not None}
        # HF Qwen2 configs may omit head_dim; derive it.
        if "head_dim" not in tc_kwargs and "hidden_size" in tc_kwargs and "num_attention_heads" in tc_kwargs:
            tc_kwargs["head_dim"] = tc_kwargs["hidden_size"] // tc_kwargs["num_attention_heads"]
        text_config = tc_cls(**tc_kwargs)
        kwargs = {k: d[k] for k in cls._MM_KEYS if k in d and d[k] is not None}
        return cls(model_type=model_type, text_config=text_config, **kwargs)

    @classmethod
    def from_pretrained(cls, model_path: str) -> "HIComConfig":
        with open(os.path.join(model_path, "config.json")) as f:
            return cls.from_hf_dict(json.load(f))

    def to_hf_dict(self) -> dict:
        d = {"model_type": self.model_type}
        d.update({k: getattr(self, k) for k in self._MM_KEYS})
        d.update(dataclasses.asdict(self.text_config))
        d["mm_hidden_size"] = self.mm_hidden_size
        return d


def tiny_test_config(**overrides) -> HIComConfig:
    """A small config for unit tests and dry runs (CPU-friendly)."""
    text = Qwen2Config(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=32,
        max_position_embeddings=2048,
        eos_token_id=2,
        pad_token_id=0,
    )
    vision = SiglipVisionConfig(
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        image_size=56,
        patch_size=14,
    )
    guide = SiglipTextConfig(
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        vocab_size=256,
        max_position_embeddings=64,
        projection_size=64,
    )
    kw = dict(
        text_config=text,
        vision_config=vision,
        guide_text_config=guide,
        mm_vision_tower="siglip-so400m-patch14-384",  # geometry key only
        mm_projector_type="local43_global32",
        num_frames=4,
        dtype="float32",
    )
    kw.update(overrides)
    return HIComConfig(**kw)
