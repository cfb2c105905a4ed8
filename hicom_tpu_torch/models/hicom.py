"""HICom model assembly: vision tower + guide encoder + projector + decoder.

Port of ``hicom_tpu/models/hicom.py`` (SigLIP towers, the hicom projector).
The module tree follows the reference checkpoint layout, so one state dict
loads with ``load_state_dict(strict=True)``::

    model.embed_tokens / model.layers.* / model.norm / lm_head    (decoder)
    model.vision_tower.vision_tower.vision_model.*                 (SigLIP vision)
    model.vision_tower.guide_encoder.text_model.*                  (SigLIP text)
    model.mm_projector.*                                           (HICom projector)
    model.image_newline                                            (anyres only)

``HIComModel`` is the causal LM itself (``language_model`` returns self), with
the multimodal parts hung under ``model`` as the reference does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import HIComConfig
from .postprocess import num_visual_tokens
from .projector import HIComProjector
from .quant import check_modes
from .qwen2 import Qwen2ForCausalLM, Qwen2Model
from .siglip import SiglipTextEncoder, SiglipVisionTower
from .splice import SplicedInputs, splice_visual_embeds

Tensor = torch.Tensor


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


class VisionTowers(nn.Module):
    def __init__(self, cfg: HIComConfig, dtype=None):
        super().__init__()
        self.vision_tower = SiglipVisionTower(cfg.vision_config, cfg.mm_vision_select_layer,
                                              with_head=cfg.guide_enabled(), dtype=dtype)
        if cfg.guide_enabled():
            self.guide_encoder = SiglipTextEncoder(cfg.guide_text_config, dtype=dtype)


class HIComQwen2Model(Qwen2Model):
    def __init__(self, cfg: HIComConfig, dtype=None):
        super().__init__(cfg.text_config, dtype=dtype)
        self.vision_tower = VisionTowers(cfg, dtype=dtype)
        self.mm_projector = HIComProjector(cfg, dtype=dtype)
        if "anyres" in (cfg.image_aspect_ratio or ""):
            self.image_newline = nn.Parameter(torch.zeros(cfg.hidden_size, dtype=dtype))
        else:
            self.image_newline = None


class HIComModel(Qwen2ForCausalLM):
    def __init__(self, config: HIComConfig):
        if "clip" in (config.mm_vision_tower or "") and "siglip" not in (config.mm_vision_tower or ""):
            raise NotImplementedError("the port carries SigLIP towers only")
        # a quantization the port does not run raises here rather than build in float
        check_modes(config.text_config.quantization, config.vision_config.quantization)
        self.hicom_config = config
        super().__init__(config.text_config, dtype=torch_dtype(config.dtype))

    def _make_model(self, cfg, dtype) -> Qwen2Model:
        return HIComQwen2Model(self.hicom_config, dtype=dtype)

    @property
    def language_model(self) -> "HIComModel":
        return self

    # ------------------------------------------------------------------ #
    # Visual encoding
    # ------------------------------------------------------------------ #

    def encode_guide(self, guide_ids: Tensor, guide_mask: Optional[Tensor] = None) -> Tensor:
        """(b, Lg) ids -> pooled (b, d), or per-token (b, Lg, d) for ``fine``."""
        pooled, per_token = self.model.vision_tower.guide_encoder(guide_ids, guide_mask)
        return per_token if self.hicom_config.use_guide == "fine" else pooled

    def encode_visual(self, frames: Tensor, guide_embeds: Optional[Tensor] = None, modal: str = "video") -> Tensor:
        """(b, t, 3, H, W) frames -> (b, V, hidden) visual tokens: SigLIP over all
        frames at once, then the projector over the batch. A frozen tower runs
        without a graph (:func:`_unless_frozen`)."""
        b, t = frames.shape[:2]
        tower = self.model.vision_tower.vision_tower
        with _unless_frozen(tower):
            features, image_embeds = tower(frames.reshape((b * t,) + frames.shape[2:]))
        features = features.reshape((b, t) + features.shape[1:])
        if image_embeds is not None:
            image_embeds = image_embeds.reshape((b, t) + image_embeds.shape[1:])
        nl = self.model.image_newline
        return self.model.mm_projector(features, image_embeds, guide_embeds, modal, nl)

    def visual_token_count(self, t: int, modal: str) -> int:
        """Visual tokens for a t-frame input (non-anyres)."""
        cfg = self.hicom_config
        hw = cfg.vision_config.num_patches_per_side
        spec = cfg.projector
        has_nl = self.model.image_newline is not None
        n = 0
        if spec.local is not None:
            kt = 1 if (modal == "image" or t == 1) else spec.local.temporal_kernel_size
            ks = spec.local.spatial_kernel_size
            thw = (math.ceil(t / kt), math.ceil(hw / ks), math.ceil(hw / ks))
            n += num_visual_tokens(cfg, thw, modal, has_newline=has_nl)
        if spec.global_ is not None:
            n += spec.global_.num_queries
        return n

    # ------------------------------------------------------------------ #
    # Text + splice + decode
    # ------------------------------------------------------------------ #

    def embed_and_splice(self, input_ids: Tensor, visual_embeds: Optional[Tensor],
                         attention_mask: Optional[Tensor] = None, labels: Optional[Tensor] = None
                         ) -> SplicedInputs:
        text_embeds = self.embed(input_ids.clamp_min(0))
        if visual_embeds is None:
            b, L = input_ids.shape
            if attention_mask is None:
                attention_mask = torch.ones((b, L), dtype=torch.bool, device=input_ids.device)
            positions = torch.arange(L, device=input_ids.device)[None].expand(b, L)
            return SplicedInputs(text_embeds, attention_mask.to(torch.bool), labels, positions)
        return splice_visual_embeds(input_ids, text_embeds, visual_embeds, attention_mask, labels)

    def decode(self, embeds: Tensor, positions: Tensor, cache=None, padding_mask: Optional[Tensor] = None):
        return self(embeds, positions, cache, padding_mask)

    # ------------------------------------------------------------------ #
    # One-shot forward (training / eval loss)
    # ------------------------------------------------------------------ #

    def one_shot_forward(self, input_ids: Tensor, frames: Optional[Tensor] = None,
                         attention_mask: Optional[Tensor] = None, labels: Optional[Tensor] = None,
                         guide_ids: Optional[Tensor] = None, guide_mask: Optional[Tensor] = None,
                         modal: str = "video") -> Tuple[Tensor, Optional[Tensor], Tensor]:
        """The JAX ``HIComModel.__call__``: guide -> ``encode_visual`` ->
        ``embed_and_splice`` with labels -> decoder. Returns (logits, spliced
        labels, attention mask). A tower or guide encoder whose parameters are
        all frozen runs under ``no_grad``, the counterpart of the JAX train
        step's ``stop_gradient`` pruning: a frozen tower costs one forward."""
        visual = None
        if frames is not None:
            guide_embeds = None
            if self.hicom_config.guide_enabled():
                with _unless_frozen(self.model.vision_tower.guide_encoder):
                    guide_embeds = self.encode_guide(guide_ids, guide_mask)
            visual = self.encode_visual(frames, guide_embeds, modal)
        spliced = self.embed_and_splice(input_ids, visual, attention_mask, labels)
        logits, _ = self.decode(spliced.embeds, spliced.positions, padding_mask=spliced.attention_mask)
        return logits, spliced.labels, spliced.attention_mask


def _unless_frozen(module: nn.Module):
    """A context that turns gradients off when no parameter of ``module`` requires one."""
    return torch.set_grad_enabled(torch.is_grad_enabled() and any(p.requires_grad for p in module.parameters()))
