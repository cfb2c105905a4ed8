"""Pipeline parallelism over the decoder's layers (GPipe-style).

Port of ``hicom_tpu/parallel/pipeline.py`` on a 1-D ``("pp",)`` device mesh
(:func:`create_pp_mesh`, one rank per stage). Stage r runs decoder layers
``[r L/S, (r+1) L/S)`` of the port's per-layer ``ModuleList`` (JAX shards the
``scan_layers`` stack on its leading axis; the port has no stacked layout).
Every rank calls :func:`pipeline_prefill` with the same embeddings.

The schedule is JAX's microbatch rotation, S + M - 1 steps: at step t, stage
r runs microbatch t - r through its layers when ``0 <= t - r < M`` (stage 0
takes it from the input, every other stage from its ring neighbour), and
hands the activation to stage r + 1 with a ring send/receive
(:class:`Rotate`; the last stage's goes to stage 0, which ignores it). The
last stage keeps its outputs; a sum over the stages (:class:`SumStages`, JAX's
``psum``) makes them whole on every stage, then the final norm is applied.
Positions are not rotated: every rank has them, and a stage reads those of
the microbatch it runs.

Gradients flow through the schedule. :class:`Rotate`'s backward sends each
activation's gradient back to the stage it came from and :class:`SumStages`
passes each rank its own gradient (every rank computes the same loss on the
whole hidden states). So that every stage takes part in every rotation's
backward, in the same order, each rotation's output reaches the loss on
every rank: stage 0 adds its received activation times 0 to its input, and
:class:`SumStages` takes the last activation of the rank as an input whose
gradient is 0. Inside a stage each layer's attention reaches K2 and, under a
gradient, K5/K6, as in the training path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.attention import group_size
from .ring import send_recv

Tensor = torch.Tensor


def create_pp_mesh(pp: Optional[int] = None, device_type: Optional[str] = None):
    """A 1-D ("pp",) ``DeviceMesh`` over the initialised process group; ``pp``
    defaults to the world and must equal it. ``device_type`` defaults to
    ``cuda`` under NCCL, else ``cpu``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError("create_pp_mesh needs an initialised process group (parallel.mesh.init_distributed)")
    world = dist.get_world_size()
    pp = world if pp is None else pp
    if pp != world:
        raise ValueError(f"a pp mesh of {pp} stages must cover the world of {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (pp,), mesh_dim_names=("pp",))


def _exchange(x: Tensor, group, shift: int) -> Tensor:
    (got,), works = send_recv((x.contiguous(),), group, shift)
    for w in works:
        w.wait()
    return got


class Rotate(torch.autograd.Function):
    """Send ``x`` to the next stage of the ring and return what the previous
    one sent; the backward sends the gradient the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, -1), None


class SumStages(torch.autograd.Function):
    """The sum of ``outs`` over the stages (JAX's ``psum``), whose gradient is
    each rank's own: the loss is computed alike on every rank from the same
    sum. ``anchor`` only ties the rank's last activation to the loss (its
    gradient is 0)."""

    @staticmethod
    def forward(ctx, outs, anchor, group):
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        total = outs.clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.anchor
        return grad, torch.zeros(shape, dtype=dtype, device=device), None


def pipeline_prefill(lm, embeds: Tensor, positions: Tensor, mesh, axis: str = "pp",
                     num_microbatches: Optional[int] = None) -> Tensor:
    """Cache-less forward with the decoder's layers split over mesh axis
    ``axis``: ``lm`` a ``Qwen2ForCausalLM`` (or its ``Qwen2Model``), embeds
    (b, L, D), positions (b, L). Returns the final-norm hidden states (b, L,
    D), the same on every stage; feed them to ``lm.logits`` or a loss.
    Requires ``num_hidden_layers % S == 0`` and ``b % M == 0`` (M defaults to
    S)."""
    from ..models.qwen2 import rotary_tables

    decoder = getattr(lm, "model", lm)
    cfg = decoder.config
    group = mesh.get_group(axis)
    S, r = group_size(group), mesh[axis].get_local_rank()
    M = num_microbatches or S
    b, L, D = embeds.shape
    if cfg.num_hidden_layers % S:
        raise ValueError(f"{cfg.num_hidden_layers} layers not divisible by pp={S}")
    if b % M:
        raise ValueError(f"batch {b} not divisible by microbatches {M}")
    per = cfg.num_hidden_layers // S
    mine = range(r * per, (r + 1) * per)
    x_mb = embeds.to(decoder.norm.weight.dtype).reshape(M, b // M, L, D)
    pos_mb = positions.reshape(M, b // M, L)

    def run_local(x, pos):
        rope = rotary_tables(pos, cfg.head_dim, cfg.rope_theta, x.dtype)
        for i in mine:
            x = decoder.layers[i](x, rope, None, i)
        return x

    # under a gradient every rotation's input must carry one, on every rank alike
    track = torch.is_grad_enabled() and any(p.requires_grad for p in decoder.parameters())
    outs = [x_mb.new_zeros(x_mb.shape[1:]) for _ in range(M)]
    buf = x_mb.new_zeros(x_mb.shape[1:])
    for t in range(S + M - 1):
        if r == 0:
            x_in = x_mb[min(t, M - 1)] + buf * 0  # ties the rotation to this rank's loss
        else:
            x_in = buf
        if track and not x_in.requires_grad:
            x_in = x_in.detach().requires_grad_()
        live = 0 <= t - r < M
        y = run_local(x_in, pos_mb[t - r]) if live else x_in
        if r == S - 1 and live:
            outs[t - (S - 1)] = y
        if t < S + M - 2 and S > 1:
            buf = Rotate.apply(y, group)
    hidden = torch.stack(outs)
    if S > 1:
        hidden = SumStages.apply(hidden, y, group)
    return decoder.norm(hidden.reshape(b, L, D))
