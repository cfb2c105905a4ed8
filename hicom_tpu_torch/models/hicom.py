"""HICom model assembly: vision tower + guide encoder + projector + decoder.

Port of ``hicom_tpu/models/hicom.py``: SigLIP or CLIP towers, the hicom or
the mean-pool projector, anyres images and multi-image prompts. The module
tree follows the reference checkpoint layout, so one state dict loads with
``load_state_dict(strict=True)``::

    model.embed_tokens / model.layers.* / model.norm / lm_head    (decoder)
    model.vision_tower.vision_tower.vision_model.*                 (SigLIP / CLIP vision)
    model.vision_tower.vision_tower.visual_projection.*            (CLIP, guide mode)
    model.vision_tower.guide_encoder.text_model.*                  (SigLIP / CLIP text)
    model.vision_tower.guide_encoder.text_projection.*             (CLIP, guide mode)
    model.mm_projector.*                                           (HICom or mean-pool projector)
    model.image_newline                                            (anyres only)

``HIComModel`` is the causal LM itself (``language_model`` returns self), with
the multimodal parts hung under ``model`` as the reference does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import HIComConfig, is_clip_tower
from ..ops.resize import resize_thw
from .anyres import AnyresPlan, apply_anyres_plan, make_anyres_plan
from .clip import ClipTextEncoder, ClipVisionTower
from .postprocess import num_visual_tokens, post_process_visual_feature
from .projector import HIComProjector, MeanPoolProjector
from .quant import check_modes
from .qwen2 import Qwen2ForCausalLM, Qwen2Model
from .siglip import SiglipTextEncoder, SiglipVisionTower
from .splice import SplicedInputs, splice_visual_embeds, splice_visual_embeds_multi

Tensor = torch.Tensor


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


class VisionTowers(nn.Module):
    """The vision tower and, in guide mode, the guide text encoder: CLIP's when
    ``mm_vision_tower`` names a CLIP tower, else SigLIP's. The contrastive
    head (SigLIP's pooling-head MLP, CLIP's ``visual_projection``) is built in
    guide mode, where its embeddings are the compression keys."""

    def __init__(self, cfg: HIComConfig, dtype=None):
        super().__init__()
        vision, text = (ClipVisionTower, ClipTextEncoder) if is_clip_tower(cfg.mm_vision_tower) else (
            SiglipVisionTower, SiglipTextEncoder)
        self.vision_tower = vision(cfg.vision_config, cfg.mm_vision_select_layer, cfg.guide_enabled(), dtype=dtype)
        if cfg.guide_enabled():
            self.guide_encoder = text(cfg.guide_text_config, dtype=dtype)


class HIComQwen2Model(Qwen2Model):
    def __init__(self, cfg: HIComConfig, dtype=None):
        super().__init__(cfg.text_config, dtype=dtype)
        self.vision_tower = VisionTowers(cfg, dtype=dtype)
        spec = cfg.projector
        if spec.kind == "hicom":
            self.mm_projector = HIComProjector(cfg, dtype=dtype)
        else:
            self.mm_projector = MeanPoolProjector(cfg.mm_hidden_size, cfg.hidden_size, spec.mlp_depth, dtype=dtype)
        if "anyres" in (cfg.image_aspect_ratio or ""):
            self.image_newline = nn.Parameter(torch.zeros(cfg.hidden_size, dtype=dtype))
        else:
            self.image_newline = None


class HIComModel(Qwen2ForCausalLM):
    def __init__(self, config: HIComConfig):
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

    def _tower(self, frames: Tensor):
        """(b, t, 3, H, W) pixels -> (features (b, t, h, w, d), image_embeds or
        None): the tower over all b * t images at once; a frozen tower runs
        without a graph (:func:`_unless_frozen`)."""
        lead = frames.shape[:2]
        tower = self.model.vision_tower.vision_tower
        with _unless_frozen(tower):
            features, image_embeds = tower(frames.reshape((-1,) + frames.shape[2:]))
        if image_embeds is not None:
            image_embeds = image_embeds.reshape(lead + image_embeds.shape[1:])
        return features.reshape(lead + features.shape[1:]), image_embeds

    def encode_visual(self, frames: Tensor, guide_embeds: Optional[Tensor] = None, modal: str = "video") -> Tensor:
        """(b, t, 3, H, W) frames -> (b, V, hidden) visual tokens: the tower over
        all frames at once, then the projector over the batch."""
        features, image_embeds = self._tower(frames)
        if self.hicom_config.projector.kind != "hicom":
            return self._mean_pool_project(features, modal)
        nl = self.model.image_newline
        return self.model.mm_projector(features, image_embeds, guide_embeds, modal, nl)

    def encode_visual_anyres(self, frames: Tensor, image_size, guide_embeds: Optional[Tensor] = None) -> Tensor:
        """One anyres image: (n, 3, H, W) crops (crop 0 the base image) of an
        image of original ``image_size`` (width, height) -> (V, hidden) tokens;
        ``guide_embeds`` (d,) or (Lg, d)."""
        cfg = self.hicom_config
        plan = make_anyres_plan(tuple(image_size), cfg, cfg.vision_config.image_size)
        return self.encode_visual_anyres_plan(frames, plan, guide_embeds)

    def encode_visual_anyres_plan(self, frames: Tensor, plan: Optional[AnyresPlan],
                                  guide_embeds: Optional[Tensor] = None) -> Tensor:
        """One anyres image under a merge plan (None: a non-spatial merge, the
        crops as frames) -> (V, hidden) tokens."""
        ge = guide_embeds[None] if guide_embeds is not None else None
        return self.encode_anyres_batch(frames[None], plan, ge)[0]

    def encode_anyres_batch(self, frames: Tensor, plan: Optional[AnyresPlan],
                            guide_embeds: Optional[Tensor] = None) -> Tensor:
        """Rows of anyres crops sharing one plan, (b, n, 3, H, W) -> (b, V,
        hidden): the tower over every crop at once, then :meth:`project_anyres`;
        the train step's path (batches grouped by plan) and, at b 1, the
        serving path."""
        return self.project_anyres(*self._tower(frames), plan, guide_embeds)

    def project_anyres(self, features: Tensor, image_embeds: Optional[Tensor], plan: Optional[AnyresPlan],
                       guide_embeds: Optional[Tensor] = None) -> Tensor:
        """Tower outputs of rows of crops, (b, n, hw, hw, d), -> (b, V, hidden):
        the merge under ``plan`` (``models/anyres.py``; host geometry, no
        device read), then :meth:`project_merged`."""
        cfg = self.hicom_config
        nl = self.model.image_newline
        mean_pool = cfg.projector.kind != "hicom"
        if plan is None:
            if mean_pool:
                return post_process_visual_feature(cfg, self.model.mm_projector(features), "image", nl, False)
            return self.model.mm_projector(features, image_embeds, guide_embeds, "image", nl)
        feat = apply_anyres_plan(features, plan)
        emb = apply_anyres_plan(image_embeds, plan) if image_embeds is not None and not mean_pool else None
        return self.project_merged(feat, emb, guide_embeds)

    def project_merged(self, feat: Dict[str, Optional[Tensor]], image_embeds: Optional[Dict] = None,
                       guide_embeds: Optional[Tensor] = None) -> Tensor:
        """The projector on a merged anyres image (``apply_anyres_plan``'s
        {"base", "patch"}) -> (b, V, hidden): the HICom projector takes the
        dict; the mean-pool one projects the base and the patch grid apart."""
        cfg = self.hicom_config
        nl = self.model.image_newline
        if cfg.projector.kind == "hicom":
            return self.model.mm_projector(feat, image_embeds, guide_embeds, "image", nl)
        parts = []
        for part, anyres in (("base", False), ("patch", True)):
            if feat[part] is not None:
                proj = self.model.mm_projector(feat[part][:, None])
                parts.append(post_process_visual_feature(cfg, proj, "image", nl, anyres))
        return torch.cat(parts, dim=-2)

    def _mean_pool_project(self, features: Tensor, modal: str) -> Tensor:
        """The mean-pool path (reference ``hicom_arch.py:193-208``): the MLP
        per token, for video a trilinear 2x2 spatial downsample, then the
        token layout."""
        _, t, h, w, _ = features.shape
        x = self.model.mm_projector(features)
        if modal == "video":
            x = resize_thw(x, (t, math.ceil(h / 2), math.ceil(w / 2)))
        return post_process_visual_feature(self.hicom_config, x, modal, self.model.image_newline, is_anyres=False)

    def visual_token_count(self, t: int, modal: str) -> int:
        """Visual tokens for a t-frame input (non-anyres)."""
        cfg = self.hicom_config
        hw = cfg.vision_config.num_patches_per_side
        spec = cfg.projector
        has_nl = self.model.image_newline is not None
        if spec.kind != "hicom":
            thw = (t, math.ceil(hw / 2), math.ceil(hw / 2)) if modal == "video" else (t, hw, hw)
            return num_visual_tokens(cfg, thw, modal, has_newline=has_nl)
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
        if visual_embeds.ndim == 4:  # (b, K, V, D): one image per sentinel of a multi-image prompt
            return splice_visual_embeds_multi(input_ids, text_embeds, visual_embeds, attention_mask, labels)
        return splice_visual_embeds(input_ids, text_embeds, visual_embeds, attention_mask, labels)

    def decode(self, embeds: Tensor, positions: Tensor, cache=None, padding_mask: Optional[Tensor] = None):
        return self(embeds, positions, cache, padding_mask)

    # ------------------------------------------------------------------ #
    # One-shot forward (training / eval loss)
    # ------------------------------------------------------------------ #

    def one_shot_forward(self, input_ids: Tensor, frames: Optional[Tensor] = None,
                         attention_mask: Optional[Tensor] = None, labels: Optional[Tensor] = None,
                         guide_ids: Optional[Tensor] = None, guide_mask: Optional[Tensor] = None,
                         modal: str = "video", multi_image: bool = False,
                         anyres_plan: Optional[AnyresPlan] = None) -> Tuple[Tensor, Optional[Tensor], Tensor]:
        """The JAX ``HIComModel.__call__``: guide -> visual tokens ->
        ``embed_and_splice`` with labels -> decoder. Returns (logits, spliced
        labels, attention mask). A tower or guide encoder whose parameters are
        all frozen runs under ``no_grad``, the counterpart of the JAX train
        step's ``stop_gradient`` pruning: a frozen tower costs one forward.

        ``multi_image``: frames (b, K, 3, H, W) are K images per row, one per
        sentinel (rows with fewer sentinels leave the surplus out).
        ``anyres_plan``: frames (b, n, 3, H, W) are the crops of one anyres
        image per row, every row under this plan."""
        visual = None
        if frames is not None:
            guide_embeds = None
            if self.hicom_config.guide_enabled():
                with _unless_frozen(self.model.vision_tower.guide_encoder):
                    guide_embeds = self.encode_guide(guide_ids, guide_mask)
            if anyres_plan is not None and modal == "image" and not multi_image:
                visual = self.encode_anyres_batch(frames, anyres_plan, guide_embeds)
            elif multi_image and modal == "image":
                b, K = frames.shape[:2]
                ge = guide_embeds.repeat_interleave(K, dim=0) if guide_embeds is not None else None
                visual = self.encode_visual(frames.reshape(b * K, 1, *frames.shape[2:]), ge, "image")
                visual = visual.reshape(b, K, *visual.shape[1:])
            else:
                visual = self.encode_visual(frames, guide_embeds, modal)
        spliced = self.embed_and_splice(input_ids, visual, attention_mask, labels)
        logits, _ = self.decode(spliced.embeds, spliced.positions, padding_mask=spliced.attention_mask)
        return logits, spliced.labels, spliced.attention_mask


def _unless_frozen(module: nn.Module):
    """A context that turns gradients off when no parameter of ``module`` requires one."""
    return torch.set_grad_enabled(torch.is_grad_enabled() and any(p.requires_grad for p in module.parameters()))
