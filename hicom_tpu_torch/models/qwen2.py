"""Qwen2/2.5 decoder with a preallocated KV cache, HF state-dict names.

Port of ``hicom_tpu/models/qwen2.py`` (unrolled layers): RMSNorm pre-norm
blocks, GQA attention with QKV bias, NeoX rotary embeddings, SwiGLU MLP; tied
embeddings optional. ``config.quantization`` picks the linears of every layer
(``models/quant.py``: ``int8``, ``nf4``, ``w8a8``, ``w8a8_mlp``, ``w8a8s``,
``w8a8s_mlp``); embeddings, norms and ``lm_head`` stay float.
``DecoderAttention`` has three modes:

* no cache: causal, right padding carried as ``kv_lengths``;
* ``prefill_from_empty``: the same attention over the new tokens, which are
  also written to the cache;
* a step over the cache: slot-causal over the cache's validity bitmap. One
  token per row goes through the K3 decode kernel on the card (its plain twin
  on the CPU) over a bf16 or int8 cache wherever its contract holds
  (``ops/flash_decode.takes_decode_kernel``: a bf16 query, head dim 64 or
  128, 1 to 8 query heads per kv head); a chunk of L > 1 tokens per row (a
  speculative verify step), and on the card a step the contract refuses
  (counted in ``cuda_build.plain_route``), takes the plain masked ``sdpa``
  over the (dequantized) cache, as in JAX, where a masked call takes XLA
  under the ``auto`` rule and the Pallas decode kernel is opt-in.

The step has two cache modes. By default every row shares the ``int`` write
offset ``length``. With ``per_slot=True`` (the serving engine, ``serve.py``)
each row is an independent serving slot with its own offset in the ``(b,)``
device tensor ``lengths``: K/V (and int8 codes and scales) are scattered at
each row's offset, each row's L new slots are set valid, and a row's token i
sees the valid slots up to its offset + i. That mode never waits for the
device, and it leaves ``lengths`` to the caller, who knows which rows
advance and by how much.

Unlike the JAX cache, :class:`KVCache` is updated in place: the tensors are
written at the offsets and ``length`` advances, which saves a copy of the
whole cache per step. With ``remat=True`` in the config, each layer of a
cache-less forward under grad mode runs inside
``torch.utils.checkpoint.checkpoint`` (the JAX ``nn.remat`` of each block): its
activations are recomputed in the backward instead of kept.

Ring prefill (``parallel/ring.py``): ``Qwen2Model.forward(...,
ring_group=)`` takes the process group (or ``ops.attention.SoloGroup``) whose
ranks each hold one equal chunk of the sequence, and hands it to every
layer's attention, where JAX reads ``config.ring_axis`` from a twin model.
Without a cache, or in a prefill from an empty cache, each layer's attention
is then ``ring_attention(..., is_causal=True)`` over the chunks; as in JAX,
for unpadded prompts only (no ``padding_mask``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import sdpa
from ..ops.cuda_build import plain_route
from ..ops.flash_decode import flash_decode, takes_decode_kernel
from .quant import decoder_layer_modes, make_linear

Tensor = torch.Tensor


@dataclass
class KVCache:
    """k/v (num_layers, b, kv_heads, max_len, head_dim); ``valid`` (b, max_len)
    marks real (non-padding) slots; ``length`` is the shared write offset and
    ``lengths`` (b,) int64 on the device the per-slot offsets (``per_slot``
    steps). int8 mode: k/v hold codes and ``k_scale``/``v_scale``
    (num_layers, b, kv_heads, max_len) per-slot absmax scales."""

    k: Tensor
    v: Tensor
    valid: Tensor
    length: int = 0
    k_scale: Optional[Tensor] = None
    v_scale: Optional[Tensor] = None
    lengths: Optional[Tensor] = None

    @classmethod
    def zeros(cls, num_layers, batch, kv_heads, max_len, head_dim, dtype, device, quantized: bool = False):
        shape = (num_layers, batch, kv_heads, max_len, head_dim)
        valid = torch.zeros((batch, max_len), dtype=torch.bool, device=device)
        lengths = torch.zeros((batch,), dtype=torch.int64, device=device)
        if quantized:
            return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device), valid, 0,
                       torch.ones(shape[:-1], dtype=torch.float32, device=device),
                       torch.ones(shape[:-1], dtype=torch.float32, device=device), lengths)
        return cls(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device),
                   valid, 0, lengths=lengths)

    def row(self, i: int) -> "KVCache":
        """Row ``i`` as a 1-row cache of views (written in place), at offset 0."""
        sl = slice(i, i + 1)
        scales = (self.k_scale[:, sl], self.v_scale[:, sl]) if self.k_scale is not None else (None, None)
        return KVCache(self.k[:, sl], self.v[:, sl], self.valid[sl], 0, *scales)


def quantize_kv(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(..., d) -> int8 codes + per-slot absmax scale (...,)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: Tensor, scale: Tensor, dtype) -> Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


def rotary_tables(positions: Tensor, head_dim: int, theta: float, dtype) -> Tuple[Tensor, Tensor]:
    """cos/sin of shape (b, L, head_dim) for NeoX-style rotation."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
                                / head_dim))
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rotary(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (b, H, L, d); cos/sin: (b, L, d)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rotated * sin[:, None]


class DecoderAttention(nn.Module):
    def __init__(self, cfg, dtype=None, quant: Optional[str] = None):
        super().__init__()
        H, KVH, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        self.num_heads, self.num_kv_heads, self.head_dim = H, KVH, hd
        bias = cfg.attention_bias
        self.q_proj = make_linear(quant, cfg.hidden_size, H * hd, bias, dtype)
        self.k_proj = make_linear(quant, cfg.hidden_size, KVH * hd, bias, dtype)
        self.v_proj = make_linear(quant, cfg.hidden_size, KVH * hd, bias, dtype)
        self.o_proj = make_linear(quant, H * hd, cfg.hidden_size, False, dtype)

    def forward(self, x: Tensor, rope: Tuple[Tensor, Tensor], cache: Optional[KVCache] = None, layer: int = 0,
                kv_lengths: Optional[Tensor] = None, prefill_from_empty: bool = False,
                slot_mask: Optional[Tensor] = None, offsets: Optional[Tensor] = None, ring_group=None) -> Tensor:
        """``rope`` = the step's (cos, sin); ``kv_lengths`` the right-padded rows'
        lengths (cache-less or prefill modes); ``slot_mask`` the visible cache
        slots of a step, (b, S) for one token per row, (b, 1, L, S) for more;
        ``offsets`` (b, L) the slots a per-slot step writes. The decoder
        computes them once per step. ``ring_group``: see the module docstring."""
        b, L, _ = x.shape
        hd = self.head_dim
        # head counts from the projections' widths: a tensor-parallel rank holds H/tp and KVH/tp heads
        q = self.q_proj(x).reshape(b, L, -1, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(b, L, -1, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(b, L, -1, hd).transpose(1, 2)
        q = apply_rotary(q, *rope)
        k = apply_rotary(k, *rope)

        if cache is None or prefill_from_empty:
            if cache is not None:
                self._write(cache, layer, k, v)
            if ring_group is not None:
                from ..parallel.ring import ring_attention

                if kv_lengths is not None:
                    raise ValueError("ring prefill requires unpadded causal prompts")
                out = ring_attention(q, k, v, ring_group, scale=hd**-0.5, is_causal=True)
            else:
                out = sdpa(q, k, v, scale=hd**-0.5, is_causal=True, kv_lengths=kv_lengths)
        else:
            self._write(cache, layer, k, v, offsets)
            quant = cache.k_scale is not None
            ck, cv = cache.k[layer], cache.v[layer]
            if L == 1 and takes_decode_kernel(q.shape, ck.shape, q.dtype, ck.dtype, q.device.type):
                out = flash_decode(q, ck, cv, slot_mask, k_scale=cache.k_scale[layer] if quant else None,
                                   v_scale=cache.v_scale[layer] if quant else None, scale=hd**-0.5)
            else:
                # a verify chunk, or a step whose operands K3's contract refuses (fp32, a head dim
                # other than 64 / 128): the plain masked path, JAX's default XLA decode
                if L == 1:
                    plain_route.add("K3")
                    slot_mask = slot_mask[:, None, None, :]
                if quant:
                    ck, cv = dequantize_kv(ck, cache.k_scale[layer], q.dtype), dequantize_kv(cv, cache.v_scale[layer],
                                                                                            q.dtype)
                out = sdpa(q, ck, cv, scale=hd**-0.5, mask=slot_mask)
        out = out.transpose(1, 2).reshape(b, L, -1)
        return self.o_proj(out)

    @staticmethod
    def _write(cache: KVCache, layer: int, k: Tensor, v: Tensor, offsets: Optional[Tensor] = None) -> None:
        if offsets is not None:  # per-slot: each row at its own offset, by device scatters
            b, KVH, L, d = k.shape
            idx = offsets[:, None, :].expand(b, KVH, L)
            pairs = [(cache.k, k), (cache.v, v)]
            if cache.k_scale is not None:
                (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
                pairs = [(cache.k, kq), (cache.v, vq)]
                cache.k_scale[layer].scatter_(2, idx, ks)
                cache.v_scale[layer].scatter_(2, idx, vs)
            for dst, src in pairs:
                dst[layer].scatter_(2, idx[..., None].expand(b, KVH, L, d), src)
            return
        off, L = cache.length, k.shape[2]
        if cache.k_scale is not None:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            cache.k[layer, :, :, off:off + L] = kq
            cache.v[layer, :, :, off:off + L] = vq
            cache.k_scale[layer, :, :, off:off + L] = ks
            cache.v_scale[layer, :, :, off:off + L] = vs
        else:
            cache.k[layer, :, :, off:off + L] = k
            cache.v[layer, :, :, off:off + L] = v


class DecoderMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, dtype=None, quant: Optional[str] = None):
        super().__init__()
        self.gate_proj = make_linear(quant, hidden, intermediate, False, dtype)
        self.up_proj = make_linear(quant, hidden, intermediate, False, dtype)
        self.down_proj = make_linear(quant, intermediate, hidden, False, dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg, dtype=None):
        super().__init__()
        attn_q, mlp_q = decoder_layer_modes(cfg.quantization)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=dtype)
        self.self_attn = DecoderAttention(cfg, dtype=dtype, quant=attn_q)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=dtype)
        self.mlp = DecoderMLP(cfg.hidden_size, cfg.intermediate_size, dtype=dtype, quant=mlp_q)

    def forward(self, x, rope, cache=None, layer=0, kv_lengths=None, prefill_from_empty=False, slot_mask=None,
                offsets=None, ring_group=None):
        x = x + self.self_attn(self.input_layernorm(x), rope, cache, layer, kv_lengths, prefill_from_empty,
                               slot_mask, offsets, ring_group)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2Model(nn.Module):
    """Decoder stack over embeddings (the multimodal splice output)."""

    def __init__(self, cfg, dtype=None):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype=dtype) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=dtype)

    def forward(self, inputs_embeds: Tensor, positions: Tensor, cache: Optional[KVCache] = None,
                padding_mask: Optional[Tensor] = None, prefill_from_empty: bool = False,
                per_slot: bool = False, ring_group=None) -> Tensor:
        """Returns the final-norm hidden states; a given cache is written in
        place. ``per_slot``: a step over ``cache.lengths``' per-row offsets,
        which it leaves as they are; ``ring_group``: this rank's chunk of a
        ring prefill (see the module docstring)."""
        cfg = self.config
        x = inputs_embeds.to(self.norm.weight.dtype)
        b, L = x.shape[:2]
        rope = rotary_tables(positions, cfg.head_dim, cfg.rope_theta, x.dtype)
        # right-padded rows: the mask is a per-row length (padded queries emit
        # values nobody reads)
        kv_lengths = padding_mask.to(torch.int32).sum(dim=-1) if padding_mask is not None else None
        slot_mask = offsets = None
        if cache is not None:
            if per_slot:  # each row's L new slots, at its own offset
                offsets = cache.lengths[:, None] + torch.arange(L, device=x.device)
                cache.valid.scatter_(1, offsets, True)
            else:
                step_valid = padding_mask.to(torch.bool) if padding_mask is not None else True
                cache.valid[:, cache.length:cache.length + L] = step_valid
            if not prefill_from_empty:
                # causality over cache SLOTS: the row's token i sees slot s if it
                # is written (valid) and s <= its offset + i; this also hides the
                # unaccepted candidates a speculative step left valid beyond it
                slots = torch.arange(cache.valid.shape[1], device=x.device)
                if per_slot:
                    last = offsets
                elif L == 1:
                    last = cache.length
                else:
                    last = (cache.length + torch.arange(L, device=x.device))[None, :]
                if L == 1:
                    slot_mask = cache.valid & (slots[None, :] <= last)
                else:
                    slot_mask = (cache.valid[:, None, :] & (slots[None, None, :] <= last[:, :, None]))[:, None]
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint(layer, x, rope, None, i, kv_lengths, ring_group=ring_group, use_reentrant=False)
            else:
                x = layer(x, rope, cache, i, kv_lengths, prefill_from_empty, slot_mask, offsets, ring_group)
        if cache is not None and not per_slot:
            cache.length += L
        return self.norm(x)


class Qwen2ForCausalLM(nn.Module):
    def __init__(self, cfg, dtype=None):
        super().__init__()
        self.config = cfg
        self.model = self._make_model(cfg, dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype)

    def _make_model(self, cfg, dtype) -> Qwen2Model:
        return Qwen2Model(cfg, dtype=dtype)

    def embed(self, input_ids: Tensor) -> Tensor:
        return self.model.embed_tokens(input_ids)

    def logits(self, hidden: Tensor) -> Tensor:
        if self.config.tie_word_embeddings:
            return hidden @ self.model.embed_tokens.weight.T
        return self.lm_head(hidden)

    def forward(self, inputs_embeds: Tensor, positions: Tensor, cache: Optional[KVCache] = None,
                padding_mask: Optional[Tensor] = None) -> Tuple[Tensor, Optional[KVCache]]:
        hidden = self.model(inputs_embeds, positions, cache, padding_mask)
        return self.logits(hidden), cache
