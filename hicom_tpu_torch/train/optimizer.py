"""Optimizer: the freeze matrix, the learning-rate groups and per-group AdamW.

Port of ``hicom_tpu/train/optimizer.py`` onto the port's state-dict names (the
reference's own, ``model.mm_projector.*``, ``model.vision_tower.*``):

* :func:`is_tunable` is the reference's ``mm_tunable_parts`` freeze matrix.
  The guide encoder sits under ``model.vision_tower.guide_encoder`` here and at
  the top level of the JAX tree, so it is told apart from the tower by name;
* :func:`lr_group` labels ``guide`` (the projector's guide injectors),
  ``projector``, ``vision`` (towers and guide encoder) and ``base``;
* :func:`decay_mask` is HF's rule: no decay on biases (any name whose last part
  contains "bias", which covers the logit-bias scalars) nor on norm weights
  (the JAX ``scale`` leaves);
* :class:`GroupAdamW` keeps the JAX package's master-weight policy
  (``param_dtype="float32"``): each trainable parameter has an fp32 master in
  the optimizer and the module's copy (bf16 at full size) is written back after
  every update; frozen parameters get ``requires_grad=False`` and no state.
  One clip by the global norm of the trainable gradients comes before the
  per-group AdamW updates, as ``optax.clip_by_global_norm`` does in the chain.
  With ``every_k`` > 1 it accumulates as ``optax.MultiSteps`` does (the JAX
  CLI's ``--gradient-accumulation-steps``): the running mean of k
  micro-batches' gradients, one clip and inner update per k calls, and the
  schedule counting inner updates. With ``init(..., offload=True)`` (the CLI's
  ``--offload-optimizer``) the moments and that mean rest in pinned host
  memory and are streamed through the device chunk by chunk, as the JAX
  package rests its optimizer state in ``pinned_host`` memory.

Over a sharded model (``parallel/sharding.shard_model``) the parameters and
gradients are DTensors: :class:`GroupAdamW` lays its flat state over each
rank's local shards, so the masters and moments are sharded as the
parameters are (JAX's optimizer state inherits its parameter's sharding).
The clip's global norm sums each tensor's squared local norm over the mesh
dims that shard it, so a tp-replicated tensor counts once. ``state_dict`` and
``load_state_dict`` keep the one-process format, full tensors by name,
whatever the mesh: a checkpoint resumes at another world size. They move one
whole tensor at a time through the device: ``state_dict`` gathers each into
rank 0's host memory, ``load_state_dict`` cuts each rank's shard from it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..models.qwen2 import RMSNorm
from ..parallel.sharding import host_whole, local

Tensor = torch.Tensor
GROUPS = ("base", "projector", "guide", "vision")


def is_tunable(name: str, tunable_parts: str, use_guide: Optional[str] = None) -> bool:
    """Reference freeze matrix (``train.py:702-738``) on a state-dict name."""
    parts = [p.strip() for p in (tunable_parts or "").split(",") if p.strip()]
    guide_on = use_guide not in (None, "off")
    in_projector = "mm_projector" in name
    in_guide = "guide_encoder" in name
    in_tower = "vision_tower" in name and not in_guide
    is_scale = ("logit_scale" in name) or ("logit_bias" in name)

    if "mm_projector" in parts and in_projector and not is_scale:
        return True
    if "pure_vision_model" in parts and in_tower and "head" not in name:
        return True
    if guide_on:
        if "vision_model_head" in parts and in_tower and "head" in name:
            return True
        if "guide_encoder" in parts and in_guide:
            return True
        if "attn_scale" in parts and in_projector and is_scale:
            return True
    if "language_model" in parts and not in_tower and not in_projector and not in_guide:
        return True
    return False


def lr_group(name: str) -> str:
    """Reference LR grouping (``hicom_trainer.py:260-268``): keyword match on
    the state-dict name."""
    if "mm_projector" in name and "guide_injector" in name:
        return "guide"
    if "mm_projector" in name:
        return "projector"
    if "vision_tower" in name or "guide_encoder" in name:
        return "vision"
    return "base"


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: decayed}: every parameter but biases and norm weights."""
    norm_weights = {f"{mod_name}.{pn}" if mod_name else pn
                    for mod_name, mod in model.named_modules() if isinstance(mod, (nn.LayerNorm, RMSNorm))
                    for pn, _ in mod.named_parameters(recurse=False)}
    return {name: "bias" not in name.rsplit(".", 1)[-1] and name not in norm_weights
            for name, _ in model.named_parameters()}


def make_schedule(lr: float, total_steps: int, warmup_ratio: float = 0.03,
                  kind: str = "cosine") -> Callable[[int], float]:
    """The learning rate of update ``count`` (0 for the first), as the JAX
    package's optax schedule gives it: a linear warmup from 0 over
    ``int(total_steps * warmup_ratio)`` updates, then cosine decay to 0 at
    ``total_steps`` (or constant)."""
    warmup = int(total_steps * warmup_ratio)

    def ramp(count: int) -> float:  # optax.linear_schedule(0, lr, warmup)
        return lr * min(max(count, 0), warmup) / warmup if warmup > 0 else 0.0

    if kind == "constant":
        return (lambda count: lr) if warmup == 0 else (lambda count: ramp(count) if count < warmup else lr)
    decay_steps = max(total_steps, warmup + 1) - warmup

    def cosine(count: int) -> float:
        if count < warmup:
            return ramp(count)
        c = min(count - warmup, decay_steps)
        return lr * 0.5 * (1 + math.cos(math.pi * c / decay_steps))

    return cosine


CHUNK = 1 << 26  # elements of one step of the update walk: 256 MB of fp32, a power of two (host pieces)
MOMENTS = ("exp_avg", "exp_avg_sq")


class GroupAdamW:
    """Per-group AdamW over fp32 masters of the trainable parameters.

    Built by :func:`build_optimizer` from the labels alone; :meth:`init` then
    freezes the module and makes the masters and moments (the JAX
    ``optimizer.init``), and :meth:`update` takes one step from the gradients
    the module's parameters hold.

    The masters are one flat fp32 buffer on the module's device, the trained
    tensors in order of (group, decayed), so that a stretch of it shares one
    learning rate and decay. The moments (and the accumulated mean) are flat
    buffers of the same layout in their home: the device, or host memory
    with ``init(..., offload=True)``. :meth:`update` walks the flat space in
    chunks of ``chunk`` elements (set before :meth:`init`); a chunk's
    gradient is cast to fp32 only there, so no fp32 copy of the whole
    gradient set exists. The per-element
    arithmetic is PyTorch's single-tensor AdamW with decoupled decay, written
    once for both homes, so the home changes no bit of the result."""

    def __init__(self, labels: Dict[str, str], decay: Dict[str, bool], schedules: Dict[str, Callable[[int], float]],
                 *, weight_decay: float, b1: float, b2: float, eps: float, max_grad_norm: Optional[float],
                 every_k: int = 1):
        self.labels, self.decay, self.schedules = labels, decay, schedules
        self.weight_decay, self.betas, self.eps = weight_decay, (b1, b2), eps
        self.max_grad_norm = max_grad_norm
        self.every_k = every_k
        self.chunk = CHUNK
        self.masters: Dict[str, Tensor] = {}
        self.count = 0  # updates taken; the schedule's argument
        self.mini_step = 0  # micro-batches accumulated towards the next update

    def freeze(self, model: nn.Module) -> Dict[str, nn.Parameter]:
        """Set ``requires_grad`` as the labels say; returns the parameters by
        name. A sharded model is frozen before it is sharded."""
        params = dict(model.named_parameters())
        if set(params) != set(self.labels):
            raise ValueError("the optimizer was built for another model")
        for name, p in params.items():
            p.requires_grad_(self.labels[name] != "frozen")
        return params

    def init(self, model: nn.Module, offload: bool = False) -> None:
        """Freeze what the labels freeze; fp32 masters on the module's device
        and zeroed moments in their home: the device, or with ``offload`` host
        memory (pinned for a CUDA device, ``parallel/sharding.py``). Over
        DTensor parameters the state covers each one's local shard."""
        params = self.freeze(model)
        names = sorted((n for n, p in params.items() if p.requires_grad),
                       key=lambda n: (GROUPS.index(self.labels[n]), not self.decay[n]))
        device = local(next(iter(params.values()))).device
        # a DTensor's mesh, placements and global shape, for the norm's reductions and state_dict's gathers
        self.sharded = {n: (params[n].device_mesh, params[n].placements, params[n].shape, params[n].stride())
                        for n in names if local(params[n]) is not params[n]}
        self.reduce_over = {n: _shard_groups(*self.sharded[n][:2]) if n in self.sharded else () for n in names}
        self.layout, total = {}, 0
        for n in names:
            shape = local(params[n]).shape
            self.layout[n] = (total, shape)
            total += shape.numel()
        self.flat = torch.empty(total, dtype=torch.float32, device=device)
        self.masters = {n: self.flat[o:o + s.numel()].view(s) for n, (o, s) in self.layout.items()}
        for n, m in self.masters.items():
            m.copy_(local(params[n]).detach())
        self.bounds = [(a, min(a + self.chunk, total)) for a in range(0, total, self.chunk)]
        # per chunk: the stretches of each tensor in it, and the runs of one (group, decayed)
        self.segments = [[(n, max(a, o), min(b, o + s.numel())) for n, (o, s) in self.layout.items()
                          if o < b and o + s.numel() > a] for a, b in self.bounds]
        self.runs = []
        for segs in self.segments:
            runs = []
            for n, lo, hi in segs:
                key = (self.labels[n], self.decay[n])
                if runs and runs[-1][2:] == key and runs[-1][1] == lo:
                    runs[-1] = (runs[-1][0], hi) + key
                else:
                    runs.append((lo, hi) + key)
            self.runs.append(runs)
        kinds = MOMENTS + (("acc",) if self.every_k > 1 else ())
        self.home = (HostHome if offload else DeviceHome)(total, self.chunk, device, kinds)
        self.gbuf = torch.empty(min(self.chunk, total), dtype=torch.float32, device=device)
        self.count = self.mini_step = 0

    def _gather(self, grads: Dict[str, Optional[Tensor]], i: int) -> Tensor:
        """Chunk ``i`` of the flat gradient in fp32 (zeros where a parameter has none)."""
        a, b = self.bounds[i]
        out = self.gbuf[:b - a]
        for n, lo, hi in self.segments[i]:
            o, g = self.layout[n][0], grads[n]
            if g is None:
                out[lo - a:hi - a].zero_()
            else:
                out[lo - a:hi - a].copy_(local(g).reshape(-1)[lo - o:hi - o])
        return out

    def _norm(self, parts) -> Tensor:
        """The global norm from (name, norm of a local part of its tensor)
        pairs: the squared norms summed, those of a sharded tensor first over
        the mesh dims that split it (a replicated one counts once)."""
        by_groups: Dict[tuple, list] = {}
        for n, x in parts:
            by_groups.setdefault(self.reduce_over[n], []).append(x)
        total = torch.zeros((), dtype=torch.float32, device=self.flat.device)
        for groups, xs in by_groups.items():
            sq = torch.stack(xs).square().sum()
            for group in groups:
                torch.distributed.all_reduce(sq, group=group)
            total = total + sq
        return total.sqrt()

    @torch.no_grad()
    def update(self, model: nn.Module) -> Tensor:
        """Clip, step and write back (with ``every_k`` > 1: accumulate, and do
        so on every k-th call only); returns the unclipped global norm of this
        call's trainable gradients (a parameter without a gradient counts as
        zeros)."""
        params = dict(model.named_parameters())
        grads = {n: params[n].grad for n in self.masters}
        norm = self._norm([(n, torch.linalg.vector_norm(local(g), dtype=torch.float32))
                           for n, g in grads.items() if g is not None])
        accumulating = self.every_k > 1
        if accumulating:
            k = self.mini_step
            self.mini_step = (k + 1) % self.every_k
            acc_norms = []
            for i, chunk in self.home.walk(self.bounds, ("acc",) if k else (), ("acc",)):
                g, acc = self._gather(grads, i), chunk["acc"]
                if k:
                    acc.add_((g - acc) / (k + 1))
                else:
                    acc.copy_(g)
                if not self.mini_step:
                    a = self.bounds[i][0]
                    acc_norms += [(n, torch.linalg.vector_norm(acc[lo - a:hi - a])) for n, lo, hi in self.segments[i]]
            if self.mini_step:
                return norm
            clip_norm = self._norm(acc_norms)
        else:
            clip_norm = norm
        lrs = {g: self.schedules[g](self.count) for g in GROUPS}
        b1, b2 = self.betas
        step = float(self.count + 1)
        bias_correction1, bias_correction2_sqrt = 1 - b1**step, (1 - b2**step) ** 0.5
        load = MOMENTS + (("acc",) if accumulating else ())
        for i, chunk in self.home.walk(self.bounds, load, MOMENTS):
            g = chunk["acc"] if accumulating else self._gather(grads, i)
            if self.max_grad_norm:
                g = torch.where(clip_norm < self.max_grad_norm, g, g / clip_norm * self.max_grad_norm)
            exp_avg, exp_avg_sq = chunk["exp_avg"], chunk["exp_avg_sq"]
            exp_avg.lerp_(g, 1 - b1)
            exp_avg_sq.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (exp_avg_sq.sqrt() / bias_correction2_sqrt).add_(self.eps)
            a = self.bounds[i][0]
            for lo, hi, group, decayed in self.runs[i]:
                master, lr = self.flat[lo:hi], lrs[group]
                if decayed and self.weight_decay:
                    master.mul_(1 - lr * self.weight_decay)
                master.addcdiv_(exp_avg[lo - a:hi - a], denom[lo - a:hi - a], value=-(lr / bias_correction1))
            for n, lo, hi in self.segments[i]:
                o = self.layout[n][0]
                local(params[n]).detach().view(-1)[lo - o:hi - o].copy_(self.flat[lo:hi])
        self.count += 1
        return norm

    def whole(self, name: str, part: Tensor) -> Optional[Tensor]:
        """The whole tensor of which ``part`` is parameter ``name``'s local
        shard, in host memory of rank 0 and None on the other ranks (every
        rank takes part in the gather: ``parallel/sharding.host_whole``); or
        ``part`` itself where the parameter is not sharded."""
        if name not in self.sharded:
            return part
        from torch.distributed.tensor import DTensor

        mesh, placements, shape, stride = self.sharded[name]
        return host_whole(DTensor.from_local(part.to(self.flat.device), mesh, placements, shape=shape, stride=stride))

    def part(self, name: str, whole: Tensor) -> Tensor:
        """This rank's shard of parameter ``name``'s whole tensor ``whole``,
        which every rank holds (cut locally, no collective)."""
        if name not in self.sharded:
            return whole
        from torch.distributed.tensor import distribute_tensor

        mesh, placements, _, _ = self.sharded[name]
        return distribute_tensor(whole.to(self.flat.device, torch.float32), mesh, placements,
                                 src_data_rank=None).to_local()

    def _by_name(self, kind: str) -> Dict[str, Tensor]:
        out = {n: self.whole(n, self.home.read(kind, o, o + s.numel()).view(s)) for n, (o, s) in self.layout.items()}
        return {n: t for n, t in out.items() if t is not None}

    def state_dict(self) -> dict:
        """Masters, moments, counts and the accumulated mean by parameter
        name, whole tensors: one format whatever the moments' home (it waits
        for the walk's last copy to host memory) and the mesh. A sharded
        state is gathered one tensor at a time into rank 0's host memory
        (every rank calls it; the other ranks' maps are empty), so the
        device never holds more than one whole tensor."""
        masters = {n: self.whole(n, m) for n, m in self.masters.items()}
        return {"masters": {n: t for n, t in masters.items() if t is not None},
                **{kind: self._by_name(kind) for kind in MOMENTS},
                "count": self.count, "mini_step": self.mini_step,
                "acc": self._by_name("acc") if self.mini_step else {}}

    def load_state_dict(self, state: dict, model: nn.Module) -> None:
        """Restore masters, moments, counts and the accumulated mean (the
        moments into their home; each rank its shards of the whole tensors,
        one tensor at a time), and write the masters back into ``model``."""
        params = dict(model.named_parameters())
        acc = state.get("acc") or {}
        with torch.no_grad():
            for n, m in self.masters.items():
                m.copy_(self.part(n, state["masters"][n]))
                local(params[n]).copy_(m)
                for kind in MOMENTS + (("acc",) if acc else ()):
                    self.home.write(kind, self.layout[n][0], self.part(n, state[kind][n]))
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))


class DeviceHome:
    """Flat fp32 optimizer state on the device: a chunk of the walk is a view
    of it, updated in place."""

    def __init__(self, numel: int, chunk: int, device: torch.device, kinds):
        self.bufs = {k: torch.zeros(numel, dtype=torch.float32, device=device) for k in kinds}

    def walk(self, bounds, load, store):
        """Yields (i, {kind: chunk i}) in order; ``load`` and ``store`` (the
        kinds the caller reads and writes) need no copy here."""
        for i, (a, b) in enumerate(bounds):
            yield i, {k: buf[a:b] for k, buf in self.bufs.items()}

    def read(self, kind: str, a: int, b: int) -> Tensor:
        return self.bufs[kind][a:b]

    def write(self, kind: str, a: int, values: Tensor) -> None:
        values = values.reshape(-1)
        self.bufs[kind][a:a + values.numel()].copy_(values)


class HostHome:
    """Flat fp32 optimizer state in host memory, one piece per chunk (pinned
    for a CUDA device, ``parallel/sharding.host_pieces``); the walk streams
    each piece through one of two device slots.

    Chunk i goes host -> device on a copy stream, is updated on the compute
    stream, and goes device -> host on a second copy stream, so both
    directions of the link run at once. Events order them: a slot is loaded
    only after the compute and the copy out of the chunk it held before are
    done, and computed on only after its load. The host reads or writes a
    piece only after :meth:`settle`. On a CPU device the copies are plain."""

    def __init__(self, numel: int, chunk: int, device: torch.device, kinds):
        from ..parallel.sharding import host_pieces

        self.pieces = {k: host_pieces(numel, chunk, device) for k in kinds}
        self.chunk, self.device = chunk, device
        width = min(chunk, numel)
        self.slots = [{k: torch.empty(width, dtype=torch.float32, device=device) for k in kinds} for _ in range(2)]
        self.cuda = device.type == "cuda"
        self.h2d = self.d2h = None
        if self.cuda:
            self.h2d, self.d2h = torch.cuda.Stream(device), torch.cuda.Stream(device)
            for slot in self.slots:
                for t in slot.values():  # the allocator waits for both copy streams before reusing a slot
                    t.record_stream(self.h2d)
                    t.record_stream(self.d2h)
            self.loaded, self.computed, self.stored = ([torch.cuda.Event() for _ in range(2)] for _ in range(3))

    def _on(self, stream):
        return torch.cuda.stream(stream) if self.cuda else contextlib.nullcontext()

    def _load(self, i: int, n: int, load) -> None:
        s = i % 2
        with self._on(self.h2d):
            if self.cuda:
                self.h2d.wait_event(self.computed[s])
                self.h2d.wait_event(self.stored[s])
            for k in load:
                self.slots[s][k][:n].copy_(self.pieces[k][i], non_blocking=True)
            if self.cuda:
                self.loaded[s].record(self.h2d)

    def walk(self, bounds, load, store):
        """Yields (i, {kind: chunk i on the device}) in order: the ``load``
        kinds hold their rested values, and the ``store`` kinds go back to
        their pieces once the caller's work on the chunk is enqueued."""
        sizes = [b - a for a, b in bounds]
        if sizes:
            self._load(0, sizes[0], load)
        for i, n in enumerate(sizes):
            if i + 1 < len(sizes):
                self._load(i + 1, sizes[i + 1], load)
            s = i % 2
            if self.cuda:
                torch.cuda.current_stream(self.device).wait_event(self.loaded[s])
            yield i, {k: t[:n] for k, t in self.slots[s].items()}
            if self.cuda:
                self.computed[s].record(torch.cuda.current_stream(self.device))
            with self._on(self.d2h):
                if self.cuda:
                    self.d2h.wait_event(self.computed[s])
                for k in store:
                    self.pieces[k][i].copy_(self.slots[s][k][:n], non_blocking=True)
                if self.cuda:
                    self.stored[s].record(self.d2h)

    def settle(self) -> None:
        """Wait until no copy reads or writes a piece."""
        if self.cuda:
            self.h2d.synchronize()
            self.d2h.synchronize()

    def _spans(self, a: int, b: int):
        for i in range(a // self.chunk, (b - 1) // self.chunk + 1):
            lo, hi = max(a, i * self.chunk), min(b, (i + 1) * self.chunk)
            yield i, lo - i * self.chunk, hi - i * self.chunk, lo - a, hi - a

    def read(self, kind: str, a: int, b: int) -> Tensor:
        """Elements [a, b) of a buffer, copied out of its pieces."""
        self.settle()
        out = torch.empty(b - a, dtype=torch.float32)
        for i, lo, hi, olo, ohi in self._spans(a, b):
            out[olo:ohi].copy_(self.pieces[kind][i][lo:hi])
        return out

    def write(self, kind: str, a: int, values: Tensor) -> None:
        self.settle()
        values = values.reshape(-1)
        for i, lo, hi, vlo, vhi in self._spans(a, a + values.numel()):
            self.pieces[kind][i][lo:hi].copy_(values[vlo:vhi])


def _shard_groups(mesh, placements) -> tuple:
    """The process groups of the mesh dims that split a DTensor (more than one
    rank each): every placement but replication (FSDP2 over a tp-split dim
    places a strided shard, which is not a ``Shard``)."""
    return tuple(mesh.get_group(i) for i, pl in enumerate(placements) if not pl.is_replicate() and mesh.size(i) > 1)


def build_optimizer(
    model: nn.Module,
    *,
    learning_rate: float,
    total_steps: int = 1000,
    warmup_ratio: float = 0.03,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    max_grad_norm: Optional[float] = 1.0,
    mm_projector_lr: Optional[float] = None,
    vision_tower_lr: Optional[float] = None,
    guide_injector_lr: Optional[float] = None,
    tunable_parts: str = "mm_projector,language_model",
    use_guide: Optional[str] = None,
    schedule_kind: str = "cosine",
    gradient_accumulation_steps: int = 1,
) -> GroupAdamW:
    """The JAX ``build_optimizer`` over ``model``'s parameter names, wrapped
    in ``optax.MultiSteps`` semantics when ``gradient_accumulation_steps`` > 1."""
    # reference fallback: guide lr set -> projector lr defaults to base lr
    if guide_injector_lr is not None and mm_projector_lr is None:
        mm_projector_lr = learning_rate
    group_lrs = {
        "base": learning_rate,
        "projector": mm_projector_lr if mm_projector_lr is not None else learning_rate,
        "guide": guide_injector_lr
        if guide_injector_lr is not None
        else (mm_projector_lr if mm_projector_lr is not None else learning_rate),
        "vision": vision_tower_lr if vision_tower_lr is not None else learning_rate,
    }
    labels = {n: lr_group(n) if is_tunable(n, tunable_parts, use_guide) else "frozen"
              for n, _ in model.named_parameters()}
    schedules = {g: make_schedule(lr, total_steps, warmup_ratio, schedule_kind) for g, lr in group_lrs.items()}
    return GroupAdamW(labels, decay_mask(model), schedules, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                      max_grad_norm=max_grad_norm, every_k=gradient_accumulation_steps)


def trainable_param_count(model: nn.Module, tunable_parts: str, use_guide: Optional[str] = None) -> int:
    return sum(p.numel() for n, p in model.named_parameters() if is_tunable(n, tunable_parts, use_guide))
