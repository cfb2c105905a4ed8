"""Autoregressive generation: prefill, then a Python decode loop over the KV cache.

Port of ``hicom_tpu/models/generate.py``. Stopping matches
``KeywordsStoppingCriteria``: generation ends at eos, or when the tail of the
generated ids equals a keyword's token ids (``stop_sequences``). As in the JAX
package, keywords match within generated tokens only, never across the
prompt/generation boundary.

``spec_k > 0`` runs prompt-lookup speculative decoding (greedy, unpadded
b = 1 only; ignored otherwise, as in JAX): each iteration drafts ``spec_k``
tokens by matching the last ``spec_ngram`` tokens of the history (prompt ids
and generated ids) against its earlier positions (:func:`pld_draft`), then
verifies them in one decoder step of ``spec_k + 1`` tokens. The emitted ids
are exactly those of ``spec_k = 0``.
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


def pld_draft(hist: Tensor, hist_len: Tensor, ngram: int, k: int) -> Tensor:
    """Prompt-lookup drafts of every row, (n, size) histories with (n,)
    lengths -> (n, k): the ``k`` tokens that followed the most recent earlier
    occurrence of the row's last ``ngram`` tokens (from position 0 when there
    is none: drafts that simply will not be accepted). JAX's ``_pld_draft``
    over rows, with its clamped slices; nothing waits for the device."""
    size = hist.shape[1]
    dev = hist.device
    pos = torch.arange(size, device=dev)
    tail_at = (hist_len - ngram).clamp(0, size - ngram)[:, None] + torch.arange(ngram, device=dev)
    tail = hist.gather(1, tail_at)
    ok = torch.ones(hist.shape, dtype=torch.bool, device=dev)
    for j in range(ngram):
        ok &= torch.roll(hist, -j, dims=1) == tail[:, j:j + 1]  # hist[i + j] == tail[j]
    # the candidate window must end strictly before the tail occurrence itself
    ok &= pos[None, :] < (hist_len - ngram)[:, None]
    best = torch.where(ok, pos[None, :], -1).amax(dim=1)
    start = torch.where(best >= 0, best + ngram, 0).clamp(0, size - k)
    return hist.gather(1, start[:, None] + torch.arange(k, device=dev))


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
    spec_k: int = 0,
    spec_ngram: int = 3,
    return_stats: bool = False,
):
    """Returns (b, max_new_tokens) generated ids, eos-padded after a stop;
    with ``return_stats`` an ``(ids, decode iterations)`` tuple (under
    speculation, emitted tokens per iteration is the decode speed-up)."""
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
    # speculation needs an unpadded single row (the verify step's validity is
    # recomputed as slot < length) and greedy sampling
    spec = spec_k if (spec_k > 0 and temperature == 0.0 and b == 1 and attention_mask is None) else 0
    return sample_and_loop(model, cache, last_hidden, true_len, max_new_tokens, temperature, top_p,
                           eos_token_id, stop_sequences, generator, spec_k=spec, spec_ngram=spec_ngram,
                           prompt_ids=input_ids, return_stats=return_stats)


def sample_and_loop(model, cache: KVCache, last_hidden: Tensor, true_len: Tensor, max_new_tokens: int,
                    temperature: float, top_p: float, eos_token_id: int, stop_sequences: tuple,
                    generator: Optional[torch.Generator] = None,
                    on_token: Optional[Callable[[int], None]] = None, spec_k: int = 0, spec_ngram: int = 3,
                    prompt_ids: Optional[Tensor] = None, return_stats: bool = False):
    """Sample the first token from the prefill's last hidden state, then decode
    one token per step until every row stopped or ``max_new_tokens`` (with
    ``spec_k``, :func:`_spec_loop`). ``on_token(step)`` is called once the
    ids of ``step`` are written (by the one-token loop)."""
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
    if spec_k > 0:
        out, iters = _spec_loop(model, cache, out, done, true_len, prompt_ids, max_new_tokens, eos_token_id,
                                stop_sequences, spec_k, spec_ngram)
        return (out, iters) if return_stats else out
    kws = [torch.as_tensor(seq, device=dev) for seq in stop_sequences]
    iters = 0
    for step in range(1, max_new_tokens):
        if bool(done.all()):
            break
        iters += 1
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
    return (out, iters) if return_stats else out


def _spec_loop(model, cache: KVCache, out: Tensor, done: Tensor, true_len: Tensor, prompt_ids: Tensor,
               max_new_tokens: int, eos_token_id: int, stop_sequences: tuple, spec_k: int, spec_ngram: int):
    """Greedy prompt-lookup speculative decode (b = 1, unpadded), JAX's
    ``_spec_loop``. Each iteration is ONE decoder step over the current token
    and ``spec_k`` drafts, written contiguously at the logical cache length;
    the longest prefix of drafts equal to the step's own argmaxes is accepted,
    emitting ``accepted + 1`` tokens up to the first stop. The cache's length
    and validity are reset to the accepted history every iteration, so the
    unaccepted tail is dropped and overwritten by the next step. One fetch of
    (emitted count, done) per iteration decides the loop. Returns
    ((1, max_new_tokens) ids, iterations)."""
    dev = out.device
    k1 = spec_k + 1
    S = cache.valid.shape[1]
    Lp = prompt_ids.shape[1]
    # token history for the n-gram lookup: the prompt ids (modal sentinels stay
    # as they are: they never match generated text) and the generated ids
    hist = torch.zeros((1, Lp + max_new_tokens + k1), dtype=torch.int64, device=dev)
    hist[0, :Lp] = prompt_ids[0]
    hist[0, Lp] = out[0, 0]
    # slack: a verify step writes k1 candidates past `step`
    buf = torch.full((1, max_new_tokens + k1), eos_token_id, dtype=torch.int64, device=dev)
    buf[0, 0] = out[0, 0]
    size = buf.shape[1]
    slots = torch.arange(S, device=dev)
    offs = torch.arange(k1, device=dev)
    kws = [torch.as_tensor(seq, device=dev) for seq in stop_sequences]
    tl = int(true_len[0])  # true_len counts the spliced prompt
    step, iters, stopped = 1, 0, bool(done.all())
    while step < max_new_tokens and not stopped:
        hist_len = Lp + step
        draft = pld_draft(hist, torch.tensor([hist_len], device=dev), spec_ngram, spec_k)[0]
        q_toks = torch.cat([buf[0, step - 1:step], draft])
        clen = tl + step - 1  # slots == rope positions: an unpadded row has no pad slots
        cache.length = clen
        torch.lt(slots, clen, out=cache.valid[0])
        # a draft may hold a modal sentinel from the prompt: it is never accepted, but must embed
        hidden = model.model(model.embed(q_toks[None].clamp_min(0)), (clen + offs)[None], cache)
        g = model.logits(hidden).float()[0].argmax(dim=-1)  # (k1,) the greedy next token at each position
        emit = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          torch.cumprod((draft == g[:spec_k]).to(torch.int64), 0).bool()])
        buf[0, step:step + k1] = g
        # stopping: an eos or keyword tail at an emitted position ends the
        # emission AT that token (it is still emitted, as in the one-token loop)
        stop_vec = g == eos_token_id
        for kw in kws:
            ks = kw.shape[0]
            for i in range(k1):
                if step + i + 1 >= ks:
                    at = min(step + i - (ks - 1), size - ks)
                    stop_vec[i] |= (buf[0, at:at + ks] == kw).all()
        stops = stop_vec & emit
        before_stop = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                                              stops.to(torch.int64)[:-1]]), 0) == 0
        keep = emit & before_stop
        hist[0, hist_len:hist_len + k1] = g
        n_emit, stopped = torch.stack([keep.sum(), (stops & keep).any().to(torch.int64)]).tolist()
        step += n_emit
        iters += 1
    # candidates written past the final emission count revert to eos
    res = buf[:, :max_new_tokens].clone()
    res[:, step:] = eos_token_id
    return res, iters
