"""SigLIP vision tower and guide text encoder, with the HF state-dict names.

Port of ``hicom_tpu/models/siglip.py`` (bf16/fp32 only):

* vision: conv patch embedding + learned position embedding, pre-LN encoder;
  the feature is ``hidden_states[select_layer]`` (default -2, the input of the
  last block) as (n, h, w, d); ``image_embeds`` = ``post_layernorm(last)`` plus
  ``head.mlp(head.layernorm(...))`` of it, the compression keys in guide mode;
* text: token + position embeddings, encoder, final LN, ``head``; pooled =
  ``head`` of the last token, per-token = ``head`` of every token.

``config.quantization`` of the vision tower picks its int8 sites
(``models/quant.py``): fc1/fc2 of every encoder layer and of the pooling
head's MLP under every mode, q/k/v over one shared activation quantization
(``qkv_quant`` for the static modes) under ``w8a8``/``w8a8_mlp_qkv``, and
out_proj under full ``w8a8``. The text encoder is never quantized.

Attention goes through ``ops.attention``: on the card the tower's unmasked
self-attention runs the K1 kernel, the text encoder's masked one the plain path.
With ``remat=True`` in the vision config, each encoder layer run under grad
mode is checkpointed (``torch.utils.checkpoint``, the JAX ``nn.remat``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..config import SiglipTextConfig, SiglipVisionConfig
from ..ops.attention import multi_head_attention
from .quant import ActQuant, W8A8LinearQ, make_tower_linear, parse_tower_quant, quant_covers, quantize_rows

Tensor = torch.Tensor


class SiglipAttention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, dtype=None, quant: Optional[str] = None):
        super().__init__()
        self.num_heads = num_heads
        base, static, _ = parse_tower_quant(quant)
        self.shared_qkv = quant_covers(base, "qkv")
        if self.shared_qkv:
            # q/k/v share one quantized input (one activation pass, three int8 products)
            self.qkv_quant = ActQuant(hidden) if static else None
            self.q_proj, self.k_proj, self.v_proj = (W8A8LinearQ(hidden, hidden, True, dtype) for _ in range(3))
        else:
            self.q_proj, self.k_proj, self.v_proj = (nn.Linear(hidden, hidden, dtype=dtype) for _ in range(3))
        out_q = ("w8a8s" if static else "w8a8") if quant_covers(base, "out") else None
        self.out_proj = make_tower_linear(out_q, hidden, hidden, dtype)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        head_dim = x.shape[-1] // self.num_heads
        if self.shared_qkv:
            xq, sx = self.qkv_quant(x) if self.qkv_quant is not None else quantize_rows(x)
            q, k, v = (p.forward_q(xq, sx) for p in (self.q_proj, self.k_proj, self.v_proj))
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        out = multi_head_attention(q, k, v, self.num_heads, scale=head_dim**-0.5, mask=mask)
        return self.out_proj(out)


class SiglipMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, dtype=None, quant: Optional[str] = None):
        super().__init__()
        base, static, _ = parse_tower_quant(quant)
        mode = ("w8a8s" if static else "w8a8") if quant_covers(base, "mlp") else None
        self.fc1 = make_tower_linear(mode, hidden, intermediate, dtype)
        self.fc2 = make_tower_linear(mode, intermediate, hidden, dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SiglipEncoderLayer(nn.Module):
    def __init__(self, hidden: int, intermediate: int, num_heads: int, eps: float, dtype=None,
                 quant: Optional[str] = None, mlp: Optional[nn.Module] = None):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden, eps=eps, dtype=dtype)
        self.self_attn = SiglipAttention(hidden, num_heads, dtype=dtype, quant=quant)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=eps, dtype=dtype)
        self.mlp = mlp if mlp is not None else SiglipMLP(hidden, intermediate, dtype=dtype, quant=quant)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class SiglipEncoder(nn.Module):
    def __init__(self, num_layers: int, hidden: int, intermediate: int, num_heads: int, eps: float,
                 dtype=None, remat: bool = False, quant: Optional[str] = None):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            SiglipEncoderLayer(hidden, intermediate, num_heads, eps, dtype=dtype, quant=quant)
            for _ in range(num_layers))

    def forward(self, x: Tensor, mask: Optional[Tensor] = None, tap_layer: int = -1,
                run_all: bool = True) -> Tuple[Optional[Tensor], Tensor]:
        """Returns (final, tapped); ``tap_layer`` indexes hidden_states (entry i
        is the input of block i, -1 the final output). With ``run_all=False``
        the blocks after the tap are skipped and ``final`` is None."""
        n = len(self.layers)
        tap = tap_layer if tap_layer >= 0 else n + 1 + tap_layer
        if not 0 <= tap <= n:
            raise ValueError(f"tap layer {tap_layer} out of range")
        tapped = x if tap == 0 else None
        remat = self.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if not run_all and i >= tap:
                break
            x = checkpoint(layer, x, mask, use_reentrant=False) if remat else layer(x, mask)
            if i + 1 == tap:
                tapped = x
        return (x if run_all else None), tapped


class SiglipVisionEmbeddings(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype=None):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size, dtype=dtype)
        self.position_embedding = nn.Embedding(cfg.num_patches, cfg.hidden_size, dtype=dtype)

    def forward(self, pixel_values: Tensor) -> Tensor:
        x = self.patch_embedding(pixel_values.to(self.patch_embedding.weight.dtype))
        x = x.flatten(2).transpose(1, 2)  # (n, h*w, d), row-major over (h, w)
        return x + self.position_embedding.weight[None]


class SiglipVisionHead(nn.Module):
    """The pooling head's LN + MLP (its probe attention is not used)."""

    def __init__(self, cfg: SiglipVisionConfig, dtype=None):
        super().__init__()
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, dtype=dtype)
        self.mlp = SiglipMLP(cfg.hidden_size, cfg.intermediate_size, dtype=dtype, quant=cfg.quantization)


class SiglipVisionTransformer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, with_head: bool, dtype=None):
        super().__init__()
        self.embeddings = SiglipVisionEmbeddings(cfg, dtype=dtype)
        self.encoder = SiglipEncoder(cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
                                     cfg.num_attention_heads, cfg.layer_norm_eps, dtype=dtype, remat=cfg.remat,
                                     quant=cfg.quantization)
        if with_head:
            self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, dtype=dtype)
            self.head = SiglipVisionHead(cfg, dtype=dtype)


class SiglipVisionTower(nn.Module):
    """(n, 3, H, W) pixels in [-1, 1] -> (features (n, h, w, d), image_embeds or None)."""

    def __init__(self, cfg: SiglipVisionConfig, select_layer: int = -2, with_head: bool = True, dtype=None):
        super().__init__()
        self.config = cfg
        self.select_layer = select_layer
        self.with_head = with_head
        self.vision_model = SiglipVisionTransformer(cfg, with_head, dtype=dtype)

    def forward(self, pixel_values: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
        cfg = self.config
        vm = self.vision_model
        n = pixel_values.shape[0]
        hw = cfg.num_patches_per_side
        x = vm.embeddings(pixel_values)
        final, tapped = vm.encoder(x, tap_layer=self.select_layer, run_all=self.with_head)
        features = tapped.reshape(n, hw, hw, cfg.hidden_size)
        if not self.with_head:
            return features, None
        last = vm.post_layernorm(final)
        h = vm.head.mlp(vm.head.layernorm(last))
        return features, (last + h).reshape(n, hw, hw, cfg.hidden_size)


class SiglipTextEmbeddings(nn.Module):
    def __init__(self, cfg: SiglipTextConfig, dtype=None):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size, dtype=dtype)


class SiglipTextTransformer(nn.Module):
    def __init__(self, cfg: SiglipTextConfig, dtype=None):
        super().__init__()
        self.embeddings = SiglipTextEmbeddings(cfg, dtype=dtype)
        self.encoder = SiglipEncoder(cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
                                     cfg.num_attention_heads, cfg.layer_norm_eps, dtype=dtype)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, dtype=dtype)
        self.head = nn.Linear(cfg.hidden_size, cfg.projection_size, dtype=dtype)


class SiglipTextEncoder(nn.Module):
    """Guide encoder: (b, L) ids -> (pooled (b, proj), per_token (b, L, proj))."""

    def __init__(self, cfg: SiglipTextConfig, dtype=None):
        super().__init__()
        self.text_model = SiglipTextTransformer(cfg, dtype=dtype)

    def forward(self, input_ids: Tensor, attention_mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        tm = self.text_model
        pair_mask = None
        if attention_mask is not None:
            pair_mask = (attention_mask > 0)[:, None, :]  # (b, 1, K), broadcast over queries
        L = input_ids.shape[-1]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[None, :L]
        final, _ = tm.encoder(x, pair_mask)
        per_token = tm.head(tm.final_layer_norm(final))
        return per_token[:, -1, :], per_token
