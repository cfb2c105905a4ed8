"""Shared building blocks with the reference's state-dict names.

Port of ``hicom_tpu/models/layers.py``: ``TorchMLP`` keeps the ``nn.Sequential``
indices ("0", "2", ...) of the reference's ``build_mlp``, and
``MultiheadAttention`` its ``q_proj``/``k_proj``/``v_proj``/``out_proj``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..ops.attention import multi_head_attention

Tensor = torch.Tensor


class TorchMLP(nn.Sequential):
    """Linear -> (GELU -> Linear) * (depth - 1), exact-erf GELU."""

    def __init__(self, in_dim: int, out_dim: int, depth: int = 2, dtype=None):
        layers = [nn.Linear(in_dim, out_dim, dtype=dtype)]
        for _ in range(1, depth):
            layers += [nn.GELU(), nn.Linear(out_dim, out_dim, dtype=dtype)]
        super().__init__(*layers)


def l2_normalize(x: Tensor, eps: float = 0.0) -> Tensor:
    """x / ||x||_2 along the last axis, computed in fp32."""
    xf = x.float()
    return (xf / (xf.square().sum(dim=-1, keepdim=True).sqrt() + eps)).to(x.dtype)


class MultiheadAttention(nn.Module):
    """The projector's attention: optional SigLIP contrastive scaling, where q
    and k are L2-normalized over the full width and the logits use
    ``exp(logit_scale)`` plus ``logit_bias`` instead of ``1/sqrt(head_dim)``."""

    def __init__(self, embed_dim: int, num_heads: int, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = nn.Linear(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = nn.Linear(embed_dim, embed_dim, dtype=dtype)
        self.out_proj = nn.Linear(embed_dim, embed_dim, dtype=dtype)

    def forward(self, query: Tensor, key: Tensor, value: Tensor,
                logit_scale: Optional[Tensor] = None, logit_bias: Union[float, Tensor] = 0.0,
                mask: Optional[Tensor] = None) -> Tensor:
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        if logit_scale is not None:
            q, k = l2_normalize(q), l2_normalize(k)
            scale, bias = torch.exp(logit_scale), logit_bias
        else:
            scale, bias = (self.embed_dim // self.num_heads) ** -0.5, 0.0
        out = multi_head_attention(q, k, v, self.num_heads, scale=scale, logit_bias=bias, mask=mask)
        return self.out_proj(out)
