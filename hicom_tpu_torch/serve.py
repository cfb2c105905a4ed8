"""Continuous-batching serving engine (slot-based, static shapes).

Port of ``hicom_tpu/serve.py`` (``ServeEngine`` without tensor-parallel
serving). The engine keeps ``n_slots`` independent sequences in ONE
persistent KV cache and decodes every resident request together, one weight
stream amortized over all of them, while requests join and leave between
rounds:

* **admission** prefills one request (its video or image through the guide
  encoder, tower and projector, the splice, then the decoder over the prompt
  right-padded to its bucket, with a mask, so the prefill runs K2 with kv
  lengths) straight into its slot's row of the engine cache, samples its
  first token on the device and scatters the slot's decode state. Nothing
  waits for the device: inputs go up through pinned memory, and the first
  token reaches the host with the round's tokens (``sync_admission`` is the
  A/B arm that fetches it at once, stalling resident slots);
* a **decode round** runs ``sync_steps`` steps over all slots through the
  decoder's ``per_slot`` mode (each row its own write offset; finished and
  idle rows are frozen in place). Three kinds: ``plain``; ``plain_hist``
  (greedy, also keeping the per-slot token history of a speculative engine);
  ``spec`` (each step verifies ``spec_k`` prompt-lookup drafts per slot in one
  ``spec_k + 1``-token step). An adaptive policy picks spec or plain rounds;
* one host fetch per round, then the host harvests finished streams (eos,
  keyword stops at round granularity, budget) and frees their slots.

On a CUDA device each greedy round kind is captured once as one CUDA graph
(all ``sync_steps`` steps over all ``n_slots``) and replayed every round:
the first round of a kind runs eagerly on the engine's capture stream (the
warm-up: library loads, cuBLAS handles, K3's split-KV workspace for that
stream, which the engine then holds), the next one is captured there, and
every later one replays the graph. Everything the graph reads lives at fixed
addresses and is updated in place (the cache, ``valid``, the per-slot
``lengths``, ``cur``, ``pos``, ``done``, ``hist``/``hist_len``, the admitted
first tokens and the round's token buffer), by admission and ``_finish``
alike. A failed capture raises. Sampled rounds (temperature > 0) run the same
step eagerly. On the CPU every round runs eagerly: the same Python function.
K3's launch counter ticks where its wrapper runs, so at capture and not at a
replay: ``graph_launches`` (per captured round) and ``replays`` count the
rest, and the class totals ``k3_captured`` / ``k3_replayed`` sum them over
every engine (the wrapper's ticks at capture, and the launches replays made).

Single video/image per request; keyword stops are applied at round
granularity, so returned text matches ``mm_infer`` with ``stop_strings``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.generate import pld_draft, sample_token
from .models.qwen2 import KVCache
from .ops.preprocess import upload_frames

Tensor = torch.Tensor


@dataclasses.dataclass
class GenRequest:
    input_ids: np.ndarray  # (L,) prompt ids with the modal sentinel spliced in
    frames: Optional[np.ndarray] = None  # (t, 3, H, W) preprocessed pixels (or a tensor)
    guide_ids: Optional[np.ndarray] = None  # (Lg,) tokenized guide text
    guide_mask: Optional[np.ndarray] = None  # (Lg,) bool; None = all real
    modal: str = "text"
    max_new_tokens: int = 64
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()


@dataclasses.dataclass
class GenResult:
    tokens: np.ndarray  # generated ids, trimmed at eos/keyword/budget
    prompt_len: int
    steps: int  # decode rounds the request was resident for
    first_token_s: float = 0.0  # host seconds from submit to the round sync that delivered the first token


@dataclasses.dataclass
class _Slot:
    request_id: int = -1
    budget: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()
    rounds: int = 0
    prompt_len: int = 0
    submitted: float = 0.0
    first_token_s: float = 0.0


class ServeEngine:
    k3_captured = 0  # K3 wrapper calls recorded into graphs (no launch), over all engines
    k3_replayed = 0  # K3 launches made by graph replays, over all engines

    def __init__(
        self,
        model,
        *,
        n_slots: int = 4,
        cache_len: int = 512,
        prompt_buckets: Tuple[int, ...] = (32, 64, 128),
        guide_len: int = 32,
        sync_steps: int = 8,
        temperature: float = 0.0,
        top_p: float = 0.9,
        eos_token_id: int = 0,
        pad_token_id: int = 0,
        seed: int = 0,
        sync_admission: bool = False,
        spec_k: int = 0,
        spec_ngram: int = 3,
        spec_adaptive: bool = True,
        spec_max_active: int = 1,
        spec_min_accept: float = 0.30,
        spec_retry_rounds: int = 16,
        device=None,
        cuda_graphs: Optional[bool] = None,
    ):
        """``model`` is the port's ``HIComModel`` on ``device`` (default the
        CUDA device; without one, pass ``device="cpu"``). ``cuda_graphs``
        (default: on a CUDA device) replays each greedy round kind as one
        CUDA graph. The other arguments are JAX's, with its defaults."""
        from .api import resolve_device

        self.device = resolve_device(device)
        self.model = model
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.guide_len = guide_len
        self.sync_steps = sync_steps
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.eos_token_id = int(eos_token_id)
        self.pad_token_id = int(pad_token_id)
        # speculative serving: every step of a spec round verifies spec_k
        # per-slot drafts; greedy only (drafts are accepted against argmax).
        # The adaptive policy (JAX's, measured there): plain rounds when more
        # than spec_max_active slots are resident, and for spec_retry_rounds
        # after the acceptance EMA drops below spec_min_accept. Plain rounds
        # of a spec engine keep the draft history, and both kinds emit the
        # exact greedy stream, so the policy only schedules work.
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.spec_adaptive = bool(spec_adaptive)
        self.spec_max_active = int(spec_max_active)
        self.spec_min_accept = float(spec_min_accept)
        self.spec_retry_rounds = int(spec_retry_rounds)
        self.spec_rounds = 0  # rounds decoded speculatively
        self.plain_rounds = 0  # plain rounds of a speculative engine
        self._accept_ema: Optional[float] = None  # optimistic until measured
        self._spec_cooldown = 0
        if self.spec_k > 0 and self.temperature != 0.0:
            raise ValueError("speculative serving (spec_k > 0) requires greedy decoding (temperature == 0)")
        # A/B arm: fetch each admission's first token at once, stalling the
        # resident slots on the prefill and the round trip
        self.sync_admission = sync_admission
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError("cuda_graphs needs a CUDA device")
        self.cuda_graphs = self.device.type == "cuda" if cuda_graphs is None else bool(cuda_graphs)

        cfg = model.hicom_config
        tc = cfg.text_config
        self._dtype = model.model.norm.weight.dtype
        n, dev, k1 = n_slots, self.device, self.spec_k + 1
        with torch.inference_mode():
            self.cache = KVCache.zeros(tc.num_hidden_layers, n, tc.num_key_value_heads, cache_len, tc.head_dim,
                                       self._dtype, dev, quantized=getattr(tc, "kv_cache_int8", False))
            # per-slot decode state lives on the device: admission scatters into it
            self._cur = torch.full((n,), self.eos_token_id, dtype=torch.int64, device=dev)
            self._pos = torch.zeros((n,), dtype=torch.int64, device=dev)
            self._done = torch.ones((n,), dtype=torch.bool, device=dev)  # empty slots are "done"
            self._first = torch.full((n,), self.eos_token_id, dtype=torch.int64, device=dev)
            # what a round hands the host in its one fetch: the admitted first
            # tokens, then the round's tokens (plain) or candidates and keeps (spec)
            self._plain_out = torch.zeros((n, 1 + sync_steps), dtype=torch.int64, device=dev)
            if self.spec_k:
                # per-slot history (raw prompt ids + generated) for the draft
                # lookup; the slack absorbs a final chunk
                self._hist = torch.zeros((n, cache_len + k1), dtype=torch.int64, device=dev)
                self._hist_len = torch.zeros((n,), dtype=torch.int64, device=dev)
                self._spec_out = torch.zeros((n + 2 * sync_steps * n * k1,), dtype=torch.int64, device=dev)
                self._chunk = torch.arange(k1, device=dev)
        self._gen = torch.Generator(dev).manual_seed(seed)

        self._slots = [_Slot() for _ in range(n)]
        self._queue: deque = deque()
        self._results: Dict[int, GenResult] = {}
        self._next_id = 0
        # (slot, budget) of this round's admissions: their first tokens ride the round's fetch
        self._pending_first: List[Tuple[int, int]] = []
        # CUDA graphs: one per round kind, a pool and a capture stream per engine
        self._graphs: Dict[str, "torch.cuda.CUDAGraph"] = {}
        self._pool = None
        self._stream = None
        self._held: List[Tensor] = []
        self.graph_launches: Dict[str, int] = {}  # K3 launches captured in one round of each kind
        self.replays: Dict[str, int] = {}  # graph replays of each kind

    # ------------------------------------------------------------- scheduling

    def submit(self, request: GenRequest) -> int:
        L = len(request.input_ids)
        bucket = self._bucket_for(L)
        if bucket is None:
            raise ValueError(f"prompt length {L} exceeds the largest bucket {self.prompt_buckets[-1]}")
        # the spliced prefill is bucket - 1 + V slots long; a round can
        # overshoot a budget/eos stop by up to one round of writes (sync_steps
        # iterations x (spec_k + 1) slots) before the host freezes the slot
        V = 0
        if request.frames is not None:
            V = self.model.visual_token_count(int(request.frames.shape[0]), request.modal)
        overshoot = self.sync_steps * (self.spec_k + 1) - 1
        if bucket + max(V - 1, 0) + request.max_new_tokens + overshoot > self.cache_len:
            raise ValueError(
                f"bucket {bucket} + {max(V - 1, 0)} more visual slots + max_new_tokens {request.max_new_tokens} "
                f"+ round overshoot {overshoot} exceeds cache_len {self.cache_len}")
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, request, time.perf_counter()))
        return rid

    @property
    def idle(self) -> bool:
        """No request queued or resident."""
        return not self._queue and all(s.request_id < 0 for s in self._slots)

    def run(self) -> Dict[int, GenResult]:
        """Process until queue and slots drain; returns {request_id: result}."""
        while not self.idle:
            self.step_round()
        out, self._results = self._results, {}
        return out

    def step_round(self) -> None:
        """One scheduler round: admit into free slots, decode ``sync_steps``
        tokens for every slot, harvest finished ones. With ``spec_k``, the
        adaptive policy picks speculative or plain per round."""
        kind = self.dispatch_round()
        if kind is not None:
            self.collect_round(kind)

    def dispatch_round(self) -> Optional[str]:
        """The device half of :meth:`step_round`: admissions and the round,
        enqueued without waiting for the device. Returns the round's kind
        (None when no slot is resident)."""
        self._admit()
        active = sum(1 for s in self._slots if s.request_id >= 0)
        if not active:
            return None
        if self._use_spec(active):
            self.spec_rounds += 1
            kind = "spec"
        elif self.spec_k:
            self.plain_rounds += 1
            kind = "plain_hist"
        else:
            kind = "plain"
        self._run_round(kind)
        return kind

    def collect_round(self, kind: str) -> None:
        """The host half: the round's one fetch (its tokens and this round's
        admitted first tokens), then the harvest."""
        out = (self._spec_out if kind == "spec" else self._plain_out).cpu().numpy()
        n = self.n_slots
        firsts = {slot: (int(out[slot] if kind == "spec" else out[slot, 0]), budget)
                  for slot, budget in self._pending_first}
        self._pending_first = []
        if kind == "spec":
            shape = (self.sync_steps, n, self.spec_k + 1)
            gs, keeps = out[n:].reshape((2,) + shape)
            keeps = keeps.astype(bool)
            self._note_acceptance(keeps)
            # per-slot emitted stream: kept candidates, iteration-major
            toks = [gs[:, r, :][keeps[:, r, :]] for r in range(n)]
        else:
            toks = out[:, 1:]
        self._harvest(toks, firsts)

    def _use_spec(self, active: int) -> bool:
        """Round-level policy: speculative decode only at low occupancy and
        while drafts land."""
        if not self.spec_k:
            return False
        if not self.spec_adaptive:
            return True
        if active > self.spec_max_active:
            return False
        if self._spec_cooldown > 0:
            self._spec_cooldown -= 1
            return False
        return True

    def _note_acceptance(self, keeps: np.ndarray) -> None:
        """The acceptance rate (extra tokens emitted per verifying
        slot-iteration / spec_k) as an EMA; a low one arms the cooldown."""
        iters_active = int(keeps[:, :, 0].sum())  # emitting slot-iterations
        if iters_active == 0:
            return
        rate = (int(keeps.sum()) - iters_active) / (iters_active * self.spec_k)
        self._accept_ema = rate if self._accept_ema is None else 0.5 * self._accept_ema + 0.5 * rate
        if self.spec_adaptive and self._accept_ema < self.spec_min_accept:
            self._spec_cooldown = self.spec_retry_rounds

    # -------------------------------------------------------------- internals

    def _bucket_for(self, L: int) -> Optional[int]:
        for b in self.prompt_buckets:
            if L <= b:
                return b
        return None

    def _upload(self, a, dtype=None) -> Tensor:
        """Host data on the engine's device, through pinned memory (no wait)."""
        t = upload_frames(a if isinstance(a, Tensor) else np.ascontiguousarray(a), self.device)
        return t if dtype is None else t.to(dtype)

    @torch.inference_mode()
    def _admit(self) -> None:
        """Dispatch-only admission into free slots: prefill, first-token
        sample, slot-state scatter; the first tokens resolve at the round's
        fetch."""
        for slot_idx, slot in enumerate(self._slots):
            if not self._queue:
                return
            if slot.request_id >= 0:
                continue
            rid, req, submitted = self._queue.popleft()
            first, spliced_len, true_len, ids = self._prefill(req, slot_idx)
            if self.sync_admission:  # A/B arm only: the stall that async admission removes
                first.cpu()
            n = slice(slot_idx, slot_idx + 1)
            self.cache.lengths[n] = spliced_len
            self._cur[n] = first
            self._pos[n] = true_len
            self._done[n] = (first == self.eos_token_id) | (req.max_new_tokens <= 1)
            self._first[n] = first
            if self.spec_k:
                # the slot's draft history: the raw prompt ids, then the first token
                L = len(req.input_ids)
                row = self._hist[slot_idx]
                row.zero_()
                row[:L] = ids[0, :L]
                row[L:L + 1] = first
                self._hist_len[n] = L + 1
            self._slots[slot_idx] = _Slot(
                request_id=rid, budget=req.max_new_tokens,
                stop_sequences=tuple(tuple(s) for s in req.stop_sequences),
                prompt_len=len(req.input_ids), submitted=submitted)
            self._pending_first.append((slot_idx, req.max_new_tokens))

    def _prefill(self, req: GenRequest, slot_idx: int):
        """Prefill ``req`` into row ``slot_idx`` of the engine cache (its
        previous occupant's validity cleared first). Returns the first token
        (1,), the spliced length, the true length (1,) and the padded ids,
        on the device."""
        m = self.model
        L = len(req.input_ids)
        bucket = self._bucket_for(L)
        ids = np.full((1, bucket), self.pad_token_id, np.int64)
        ids[0, :L] = req.input_ids
        mask = np.zeros((1, bucket), bool)
        mask[0, :L] = True
        ids_d, mask_d = self._upload(ids), self._upload(mask)
        visual = None
        if req.frames is not None:
            frames = self._upload(req.frames[None], self._dtype)
            ge = None
            if m.hicom_config.guide_enabled():
                g = np.zeros((1, self.guide_len), np.int64)
                gm = np.zeros((1, self.guide_len), bool)
                if req.guide_ids is not None:
                    Lg = min(len(req.guide_ids), self.guide_len)
                    g[0, :Lg] = np.asarray(req.guide_ids)[:Lg]
                    gm[0, :Lg] = np.asarray(req.guide_mask)[:Lg] if req.guide_mask is not None else True
                ge = m.encode_guide(self._upload(g), self._upload(gm))
            visual = m.encode_visual(frames, ge, req.modal)
        sp = m.embed_and_splice(ids_d, visual, mask_d)
        row = self.cache.row(slot_idx)
        row.valid.zero_()
        hidden = m.model(sp.embeds, sp.positions, row, padding_mask=sp.attention_mask, prefill_from_empty=True)
        true_len = sp.attention_mask.to(torch.int64).sum(dim=1)
        last = hidden.gather(1, (true_len - 1)[:, None, None].expand(1, 1, hidden.shape[-1]))
        first = sample_token(m.logits(last)[:, 0], self._gen, self.temperature, self.top_p)
        return first, sp.embeds.shape[1], true_len, ids_d

    def _run_round(self, kind: str) -> None:
        fn = {"plain": lambda: self._round_plain(False), "plain_hist": lambda: self._round_plain(True),
              "spec": self._round_spec}[kind]
        with torch.inference_mode():
            if not (self.cuda_graphs and (kind != "plain" or self.temperature == 0.0)):
                fn()
            elif kind in self._graphs:
                self._graphs[kind].replay()
                self.replays[kind] += 1
                ServeEngine.k3_replayed += self.graph_launches[kind]
            else:
                self._graphs[kind] = self._capture(kind, fn)

    def _capture(self, kind: str, fn) -> "torch.cuda.CUDAGraph":
        """Run this round of ``kind`` eagerly on the capture stream (the
        warm-up), then capture the next one's work as a graph."""
        from .ops import flash_decode as fd

        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        s, main = self._stream, torch.cuda.current_stream(self.device)
        s.wait_stream(main)
        with torch.cuda.stream(s):
            fn()
        main.wait_stream(s)
        # K3's split-KV scratch for this stream, made by the warm-up: the graph
        # holds its address, so the engine holds the tensor
        self._held += [ws for (_, st), ws in fd._workspaces.items() if st == s.cuda_stream]
        graph = torch.cuda.CUDAGraph()
        before = fd.flash_decode.launches
        with torch.cuda.graph(graph, pool=self._pool, stream=s):
            fn()
        self.graph_launches[kind] = fd.flash_decode.launches - before
        ServeEngine.k3_captured += self.graph_launches[kind]
        self.replays[kind] = 0
        return graph

    def _round_plain(self, hist: bool) -> None:
        """``sync_steps`` one-token steps over every slot; with ``hist`` (a
        speculative engine's plain round, greedy) the draft history too."""
        m, c, eos = self.model, self.cache, self.eos_token_id
        out = self._plain_out
        out[:, 0] = self._first
        for s in range(self.sync_steps):
            hidden = m.model(m.embed(self._cur[:, None]), self._pos[:, None], c, per_slot=True)
            tok = sample_token(m.logits(hidden)[:, 0], self._gen, self.temperature, self.top_p)
            tok = tok.masked_fill(self._done, eos)
            # finished/idle rows are frozen: their write offset cannot creep
            live = (~self._done).to(torch.int64)
            c.lengths += live
            self._pos += live
            if hist:
                at = self._hist_len[:, None]
                self._hist.scatter_(1, at, torch.where(self._done[:, None], self._hist.gather(1, at), tok[:, None]))
                self._hist_len += live
            self._done |= tok == eos
            self._cur.copy_(tok)
            out[:, 1 + s] = tok

    def _round_spec(self) -> None:
        """``sync_steps`` verify steps: each slot's current token and
        ``spec_k`` prompt-lookup drafts in ONE ``spec_k + 1``-token per-slot
        step; each slot keeps its longest accepted prefix up to an eos (the
        invariants of ``models/generate.py:_spec_loop``, per row)."""
        m, c, eos = self.model, self.cache, self.eos_token_id
        n, k, steps = self.n_slots, self.spec_k, self.sync_steps
        ar = self._chunk
        out = self._spec_out
        out[:n] = self._first
        gs = out[n:n + steps * n * (k + 1)].view(steps, n, k + 1)
        keeps = out[n + steps * n * (k + 1):].view(steps, n, k + 1)
        cur, pos, done = self._cur, self._pos, self._done
        hist, hist_len = self._hist, self._hist_len
        for s in range(steps):
            draft = pld_draft(hist, hist_len, self.spec_ngram, k)
            q_toks = torch.cat([cur[:, None], draft], dim=1)
            # a draft may hold a modal sentinel of the prompt: never accepted, but it must embed
            hidden = m.model(m.embed(q_toks.clamp_min(0)), pos[:, None] + ar, c, per_slot=True)
            g = m.logits(hidden).float().argmax(dim=-1)  # (n, k + 1) greedy
            g = g.masked_fill(done[:, None], eos)
            ones = torch.ones((n, 1), dtype=torch.bool, device=g.device)
            emit = torch.cat([ones, torch.cumprod((draft == g[:, :k]).to(torch.int64), dim=1).bool()], dim=1)
            hit = (g == eos) & emit
            before = torch.cumsum(torch.cat([~ones, hit[:, :-1]], dim=1).to(torch.int64), dim=1) == 0
            keep = emit & before & ~done[:, None]
            n_emit = keep.sum(dim=1)
            c.lengths += n_emit  # finished rows emit nothing: frozen in place
            pos += n_emit
            new_cur = g.gather(1, (n_emit - 1).clamp_min(0)[:, None])[:, 0].masked_fill(done, eos)
            at = hist_len[:, None] + ar
            hist.scatter_(1, at, torch.where(done[:, None], hist.gather(1, at), g))
            hist_len += n_emit
            done |= (hit & keep).any(dim=1)
            cur.copy_(new_cur)
            gs[s] = g
            keeps[s] = keep

    def _harvest(self, toks, firsts=None) -> None:
        firsts = firsts or {}
        now = time.perf_counter()
        for slot_idx, slot in enumerate(self._slots):
            if slot.request_id < 0:
                continue
            slot.rounds += 1
            finished = False
            stream = list(toks[slot_idx])
            if slot_idx in firsts:
                # the prefill's first token (deferred from the asynchronous admission)
                first, budget = firsts[slot_idx]
                slot.first_token_s = now - slot.submitted
                stream = [first] + stream
                if budget <= 1:  # max_new_tokens 1: the first token is all
                    stream = stream[:1] if first != self.eos_token_id else []
                    finished = True
                    slot.generated.extend(stream)
                    stream = []
            for t in stream:
                t = int(t)
                if t == self.eos_token_id:
                    finished = True
                    break
                slot.generated.append(t)
                if len(slot.generated) >= slot.budget:
                    finished = True
                    break
            # keyword stop (round granularity: the same text as mm_infer's trim)
            for seq in slot.stop_sequences:
                n = len(seq)
                for i in range(len(slot.generated) - n + 1):
                    if tuple(slot.generated[i:i + n]) == seq:
                        slot.generated = slot.generated[:i]
                        finished = True
                        break
                if finished:
                    break
            if finished:
                self._finish(slot_idx)

    @torch.inference_mode()
    def _finish(self, slot_idx: int) -> None:
        slot = self._slots[slot_idx]
        self._results[slot.request_id] = GenResult(
            tokens=np.asarray(slot.generated, np.int32), prompt_len=slot.prompt_len, steps=slot.rounds,
            first_token_s=slot.first_token_s)
        self._slots[slot_idx] = _Slot()
        # in place, without a host sync: a freed slot decodes dead air until
        # reused, which its done flag freezes
        self._done[slot_idx] = True
        self._cur[slot_idx] = self.eos_token_id
