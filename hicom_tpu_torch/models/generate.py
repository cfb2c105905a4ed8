"""Autoregressive generation: prefill, then a Python decode loop over the KV cache.

Port of ``hicom_tpu/models/generate.py`` (no speculative decode). Stopping
matches ``KeywordsStoppingCriteria``: generation ends at eos, or when the tail
of the generated ids equals a keyword's token ids (``stop_sequences``). As in
the JAX package, keywords match within generated tokens only, never across the
prompt/generation boundary.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .qwen2 import KVCache

Tensor = torch.Tensor


def sample_token(logits: Tensor, generator: Optional[torch.Generator], temperature: float, top_p: float) -> Tensor:
    """logits (b, vocab) -> token (b,). Greedy when temperature == 0."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits.float() / temperature
    sorted_logits = logits.sort(dim=-1, descending=True).values
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    # keep tokens until the cumulative probability exceeds top_p (always the top-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
    cutoff_logit = sorted_logits.gather(-1, cutoff_idx)
    logits = logits.masked_fill(logits < cutoff_logit, float("-inf"))
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]


def keyword_token_sequences(keywords, tokenizer) -> tuple:
    """Tokenize stop keywords as ``KeywordsStoppingCriteria`` does: plain
    ``tokenizer(kw).input_ids`` with a leading bos stripped."""
    seqs = []
    for kw in keywords:
        ids = list(tokenizer(kw).input_ids)
        if len(ids) > 1 and tokenizer.bos_token_id is not None and ids[0] == tokenizer.bos_token_id:
            ids = ids[1:]
        if ids:
            seqs.append(tuple(int(i) for i in ids))
    return tuple(seqs)


@torch.inference_mode()
def generate_tokens(
    model,
    input_ids: Tensor,  # (b, L) with a modal sentinel
    frames: Optional[Tensor],  # (b, t, 3, H, W) or None
    guide_ids: Optional[Tensor],
    guide_mask: Optional[Tensor],
    attention_mask: Optional[Tensor] = None,  # (b, L) bool; None = all real
    visual_embeds: Optional[Tensor] = None,  # (b, V, D) precomputed (the anyres path)
    *,
    modal: str = "video",
    max_new_tokens: int = 128,
    temperature: float = 0.0,
    top_p: float = 0.9,
    eos_token_id: int = 0,
    cache_len: int = 4096,
    stop_sequences: tuple = (),
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Returns (b, max_new_tokens) generated ids, eos-padded after a stop."""
    cfg = model.hicom_config
    b = input_ids.shape[0]
    visual = visual_embeds
    has_frames = frames is not None or visual is not None
    if frames is not None and visual is None:
        guide_embeds = model.encode_guide(guide_ids, guide_mask) if cfg.guide_enabled() else None
        visual = model.encode_visual(frames, guide_embeds, modal)
    spliced = model.embed_and_splice(input_ids, visual, attention_mask)

    tc = cfg.text_config
    dtype = model.model.norm.weight.dtype
    cache = KVCache.zeros(tc.num_hidden_layers, b, tc.num_key_value_heads, cache_len, tc.head_dim, dtype,
                          input_ids.device, quantized=getattr(tc, "kv_cache_int8", False))
    # b=1 unpadded multimodal prompts splice to an all-valid mask: plain causal prefill
    prefill_pm = None if (attention_mask is None and b == 1 and has_frames) else spliced.attention_mask
    hidden = model.model(spliced.embeds, spliced.positions, cache, padding_mask=prefill_pm,
                         prefill_from_empty=True)
    true_len = spliced.attention_mask.to(torch.int64).sum(dim=1)  # (b,)
    last_hidden = hidden.gather(1, (true_len - 1)[:, None, None].expand(b, 1, hidden.shape[-1]))
    return sample_and_loop(model, cache, last_hidden, true_len, max_new_tokens, temperature, top_p,
                           eos_token_id, stop_sequences, generator)


def sample_and_loop(model, cache: KVCache, last_hidden: Tensor, true_len: Tensor, max_new_tokens: int,
                    temperature: float, top_p: float, eos_token_id: int, stop_sequences: tuple,
                    generator: Optional[torch.Generator] = None,
                    on_token: Optional[Callable[[int], None]] = None) -> Tensor:
    """Sample the first token from the prefill's last hidden state, then decode
    one token per step until every row stopped or ``max_new_tokens``.
    ``on_token(step)`` is called once the ids of ``step`` are written."""
    b = last_hidden.shape[0]
    dev = last_hidden.device
    first = sample_token(model.logits(last_hidden)[:, 0], generator, temperature, top_p)
    out = torch.full((b, max_new_tokens), eos_token_id, dtype=torch.int64, device=dev)
    out[:, 0] = first
    if on_token is not None:
        on_token(0)
    done = first == eos_token_id
    for seq in stop_sequences:  # single-token keywords can stop at step 0
        if len(seq) == 1:
            done |= first == seq[0]
    kws = [torch.as_tensor(seq, device=dev) for seq in stop_sequences]
    for step in range(1, max_new_tokens):
        if bool(done.all()):
            break
        cur = out[:, step - 1]
        # rope position = per-row true length (pads excluded), not the cache slot
        positions = (true_len + step - 1)[:, None]
        hidden = model.model(model.embed(cur[:, None]), positions, cache)
        tok = sample_token(model.logits(hidden)[:, 0], generator, temperature, top_p)
        tok = torch.where(done, torch.full_like(tok, eos_token_id), tok)
        out[:, step] = tok
        if on_token is not None:
            on_token(step)
        done |= tok == eos_token_id
        for kw in kws:
            k = kw.shape[0]
            if step + 1 >= k:
                done |= (out[:, step - k + 1:step + 1] == kw).all(dim=1)
    return out
