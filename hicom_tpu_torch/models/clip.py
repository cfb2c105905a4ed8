"""CLIP vision tower and guide text encoder (clip-vit-large-patch14-336), with the HF state-dict names.

Port of ``hicom_tpu/models/clip.py`` (HF ``CLIPVisionModelWithProjection`` /
``CLIPTextModelWithProjection``):

* vision: CLS token + conv patch embedding + learned positions, pre-LN,
  quick-GELU MLPs; the feature is ``hidden_states[select_layer][:, 1:]`` (CLS
  dropped) as (n, h, w, d); ``image_embeds`` = ``visual_projection(
  post_layernorm(last)[:, 1:])``, the compression keys in guide mode;
* text: a causal encoder (a padding mask combines with it); pooled = the
  projected token at the first eos, per-token = every projected token.

The layers are SigLIP's (``models/siglip.py``) with a quick-GELU MLP, so
attention goes through ``ops.attention`` as there: on the card the vision
tower's unmasked self-attention (577 tokens, d 64) runs the K1 kernel, the
text encoder's masked one the plain path. ``remat=True`` in the vision config
checkpoints each encoder layer under grad mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ClipTextConfig, ClipVisionConfig  # noqa: F401  (re-exported)
from .siglip import SiglipEncoder, SiglipEncoderLayer

Tensor = torch.Tensor


def quick_gelu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate, dtype=dtype)
        self.fc2 = nn.Linear(intermediate, hidden, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class ClipEncoder(SiglipEncoder):
    """SigLIP's encoder loop (hidden-state tap, remat) over SigLIP's layers with CLIP's MLP."""

    def __init__(self, num_layers: int, hidden: int, intermediate: int, num_heads: int, eps: float,
                 dtype=None, remat: bool = False):
        nn.Module.__init__(self)
        self.remat = remat
        self.layers = nn.ModuleList(
            SiglipEncoderLayer(hidden, intermediate, num_heads, eps, dtype=dtype,
                               mlp=ClipMLP(hidden, intermediate, dtype=dtype)) for _ in range(num_layers))


class ClipVisionEmbeddings(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, dtype=None):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size, dtype=dtype))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size, bias=False,
                                         dtype=dtype)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, cfg.hidden_size, dtype=dtype)

    def forward(self, pixel_values: Tensor) -> Tensor:
        x = self.patch_embedding(pixel_values.to(self.patch_embedding.weight.dtype))
        x = x.flatten(2).transpose(1, 2)  # (n, h*w, d), row-major over (h, w)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class ClipVisionTransformer(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, with_projection: bool, dtype=None):
        super().__init__()
        self.embeddings = ClipVisionEmbeddings(cfg, dtype=dtype)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, dtype=dtype)
        self.encoder = ClipEncoder(cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
                                   cfg.num_attention_heads, cfg.layer_norm_eps, dtype=dtype, remat=cfg.remat)
        if with_projection:
            self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, dtype=dtype)


class ClipVisionTower(nn.Module):
    """(n, 3, H, W) pixels -> (features (n, h, w, d), image_embeds (n, h, w, proj) or None)."""

    def __init__(self, cfg: ClipVisionConfig, select_layer: int = -2, with_projection: bool = True, dtype=None):
        super().__init__()
        self.config = cfg
        self.select_layer = select_layer
        self.with_projection = with_projection
        self.vision_model = ClipVisionTransformer(cfg, with_projection, dtype=dtype)
        if with_projection:
            self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False, dtype=dtype)

    def forward(self, pixel_values: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
        cfg = self.config
        vm = self.vision_model
        n, hw = pixel_values.shape[0], cfg.num_patches_per_side
        x = vm.pre_layrnorm(vm.embeddings(pixel_values))
        final, tapped = vm.encoder(x, tap_layer=self.select_layer, run_all=self.with_projection)
        features = tapped[:, 1:].reshape(n, hw, hw, cfg.hidden_size)
        if not self.with_projection:
            return features, None
        embeds = self.visual_projection(vm.post_layernorm(final)[:, 1:])
        return features, embeds.reshape(n, hw, hw, cfg.projection_dim)


class ClipTextEmbeddings(nn.Module):
    def __init__(self, cfg: ClipTextConfig, dtype=None):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size, dtype=dtype)


class ClipTextTransformer(nn.Module):
    def __init__(self, cfg: ClipTextConfig, dtype=None):
        super().__init__()
        self.embeddings = ClipTextEmbeddings(cfg, dtype=dtype)
        self.encoder = ClipEncoder(cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
                                   cfg.num_attention_heads, cfg.layer_norm_eps, dtype=dtype)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, dtype=dtype)


class ClipTextEncoder(nn.Module):
    """Guide encoder: (b, L) ids -> (pooled (b, proj), per_token (b, L, proj))."""

    def __init__(self, cfg: ClipTextConfig, dtype=None):
        super().__init__()
        self.config = cfg
        self.text_model = ClipTextTransformer(cfg, dtype=dtype)
        self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False, dtype=dtype)

    def forward(self, input_ids: Tensor, attention_mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        tm = self.text_model
        L = input_ids.shape[-1]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[None, :L]
        mask = torch.ones((L, L), dtype=torch.bool, device=input_ids.device).tril()[None]
        if attention_mask is not None:
            mask = mask & (attention_mask[:, None, :] > 0)
        final, _ = tm.encoder(x, mask)
        per_token = self.text_projection(tm.final_layer_norm(final))
        # HF pooling: the token at the first eos
        eos_pos = (input_ids == self.config.eos_token_id).to(torch.int64).argmax(dim=-1)
        pooled = per_token.gather(1, eos_pos[:, None, None].expand(-1, 1, per_token.shape[-1]))[:, 0]
        return pooled, per_token
