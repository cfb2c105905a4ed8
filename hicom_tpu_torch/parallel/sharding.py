"""Where training state rests: the sharding rules, the sharded model, each
rank's slice of the batch, and the host offload of the optimizer state.

Port of ``hicom_tpu/parallel/sharding.py``.

**Rules.** :data:`DEFAULT_RULES` are JAX's (path regex -> spec), first match
wins, on this package's state-dict names (``model.layers.N.self_attn.q_proj.
weight``, ``model.vision_tower.…``, ``model.mm_projector.…``) and in torch's
layouts: a Linear weight is (out, in), so JAX's kernel spec ``P("fsdp",
"tp")`` on (in, out) reads ``("tp", "fsdp")`` here, a split of the output
rows on tp. A spec whose axis sizes do not divide the tensor falls back to
replication (:func:`spec_for_path`), as in JAX.

**The sharded model** (:func:`shard_model`). On the ``tp`` sub-mesh,
``parallelize_module`` makes a Linear whose rule splits its rows on tp
column-parallel (q/k/v, gate/up, fc1, ``lm_head``) and one whose rule splits
its inputs row-parallel (o, down, out_proj, fc2); the decoder's token
embedding splits its hidden dim. Every parallel layer hands its neighbours
plain local tensors (``use_local_output``), so the attention kernels see
``H/tp`` query and ``KVH/tp`` key heads of plain memory, never a DTensor.
Where the port departs from XLA's placements (:func:`param_shardings`):

* a kernel cannot take half a head, so an attention block whose query or
  key/value head count does not divide by tp stays replicated whole (q, k,
  v and o), where XLA splits any divisible column count: Qwen2.5-7B's 28
  query and 4 KV heads at tp 8;
* a column-parallel Linear's bias is split with its rows; JAX's rules
  replicate every bias;
* the token embedding of a model with tied embeddings stays replicated
  (its transpose is the output head);
* the vocab-parallel logits are gathered to a replicated tensor before the
  loss, where XLA keeps them split on tp.

On the ``(dp, fsdp)`` sub-mesh FSDP2's ``fully_shard`` wraps every decoder,
tower and guide-encoder layer and the root (HSDP: replicated over dp,
sharded over fsdp). FSDP2 shards dim 0 of every tensor of a unit (ZeRO-3),
where XLA shards only the dim a rule names and replicates the rest; the
arithmetic is the same.

**The batch.** Each rank reads its contiguous slice of the global batch,
indexed by its data coordinate (dp x fsdp, ``parallel/mesh.py``); the tp
ranks of a data group read the same rows (:func:`shard_batch_tree`).

**Tensor-parallel serving** (:func:`tp_serving_model`, JAX's
``ServeEngine._shard_to_mesh``): a replica of a built model whose blocks
hold one tp rank's slices as views of the caller's tensors, so the caller's
model still answers whole. A block (an attention's q/k/v and o or
out_proj, an MLP's gate/up and down or fc1 and fc2) is split when
:func:`param_shardings` splits every one of its linears on tp and each is
a plain ``nn.Linear``: the column-parallel linears keep their rank's output
rows (a contiguous view), the row-parallel one its input columns (a strided
view that the GEMM reads in place) and sums its output over the tp group
with an explicit ``dist.all_reduce``. Every other block stays whole on every
rank, with no sum: one whose heads do not divide by tp, and one holding a
quantized linear (JAX's rules match no ``kernel_q`` and replicate it). The
decoder's attention is split in every layer or in none, so that one KV
cache layout serves all layers. ``lm_head`` is column-parallel and its
logits are all-gathered, so that every rank samples from the whole
vocabulary; the token embedding stays whole (JAX splits its hidden dim).
The collectives are issued at one rank too, where each is a copy, and their
wrappers count their calls (``launches``), as the kernel wrappers do.

**Host offload** of the optimizer state, the counterpart of
``supports_host_offload`` and ``host_offload_shardings``: JAX gives the
optimizer-state subtree a ``pinned_host`` memory kind and XLA streams it
around each update; here the optimizer's flat fp32 state is held in host
pieces that its update walk copies in and out (``train/optimizer.py``).
PyTorch's pinned (caching host) allocator rounds a request up to the next
power of two, so a moment pinned as one tensor can take nearly twice its
bytes (a 2.18 GB embedding moment takes 4.29 GB). The pieces here are a
power of two each, and only the last piece of a buffer is rounded.
"""

from __future__ import annotations

import copy
import itertools
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from .mesh import MESH_AXES, data_coordinate, data_rows

Spec = Tuple[Optional[str], ...]

# Order matters: first match wins. Specs are per dim of the torch tensor.
_LM = r"^(?:lm_head|model\.(?:embed_tokens|layers\.\d+|norm))\."
DEFAULT_RULES: List[Tuple[str, Spec]] = [
    # --- decoder (Qwen2 / Llama) ---
    # hidden-sharded (not vocab-sharded), as in JAX: the lookup's output is tp-split on D
    (r"^model\.embed_tokens\.weight$", ("fsdp", "tp")),
    (r"^model\.layers\.\d+\..*(?:q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$", ("tp", "fsdp")),
    (r"^model\.layers\.\d+\..*(?:o_proj|down_proj)\.weight$", ("fsdp", "tp")),
    (r"^lm_head\.weight$", ("tp", "fsdp")),
    (_LM + r"(?:.*\.)?(?:layernorm|norm)\.weight$", ()),
    (_LM + r".*bias$", ()),
    # --- vision tower / guide encoder: fsdp-shard the big matrices ---
    (r"^model\.vision_tower\..*(?:q_proj|k_proj|v_proj|fc1)\.weight$", ("tp", "fsdp")),
    (r"^model\.vision_tower\..*(?:out_proj|fc2)\.weight$", ("fsdp", "tp")),
    # tower embeddings replicate (JAX: a d-sharded table collides with the batch-sharded layers)
    (r"^model\.vision_tower\..*embedding\.weight$", ()),
    (r"^model\.vision_tower\..*head\.weight$", (None, "fsdp")),
    # --- projector: small; shard readout rows (JAX kernels' input dim) on fsdp ---
    (r"^model\.mm_projector\..*(?<!norm)\.weight$", (None, "fsdp")),
    # everything else replicated
    (r".*", ()),
]


def _sizes(mesh) -> Mapping[str, int]:
    """{axis: size} of a DeviceMesh or of a mapping already."""
    if isinstance(mesh, Mapping):
        return mesh
    return {a: mesh[a].size() for a in MESH_AXES}


def _spec_fits(spec: Spec, shape: Sequence[int], mesh) -> bool:
    sizes = _sizes(mesh)
    if len(spec) > len(shape):
        return False
    for dim, axis in zip(shape, spec):
        if axis is None:
            continue
        size = 1
        for a in (axis,) if isinstance(axis, str) else axis:
            size *= sizes[a]
        if dim % size:
            return False
    return True


def spec_for_path(name: str, shape: Sequence[int], mesh, rules=None) -> Spec:
    """The first rule matching the state-dict ``name``; replication when its
    axis sizes do not divide ``shape``. ``mesh``: a DeviceMesh or {axis: size}."""
    for pattern, spec in rules or DEFAULT_RULES:
        if re.search(pattern, name):
            return spec if _spec_fits(spec, shape, mesh) else ()
    return ()


def _drop_tp(spec: Spec) -> Spec:
    return tuple(None if a == "tp" else a for a in spec)


def _undivided_heads(model: nn.Module, tp: int) -> set:
    """The attention modules whose heads do not divide by tp: the decoder's
    query or KV head count, a tower attention's head count."""
    from ..models.qwen2 import DecoderAttention
    from ..models.siglip import SiglipAttention

    return {name for name, mod in model.named_modules()
            if isinstance(mod, DecoderAttention) and (mod.num_heads % tp or mod.num_kv_heads % tp)
            or isinstance(mod, SiglipAttention) and mod.num_heads % tp}


def param_shardings(model: nn.Module, mesh, rules=None) -> Dict[str, Spec]:
    """{parameter name: spec} as the port places it: :func:`spec_for_path`
    with the port's departures from XLA (module docstring): the tp split of
    an attention block whose heads do not divide by tp dropped from all of
    its projections, the tp split of a tied embedding dropped, and a
    column-parallel Linear's bias split on tp with its rows. ``mesh``: a
    DeviceMesh or {axis: size}."""
    tp = _sizes(mesh)["tp"]
    params = dict(model.named_parameters())
    specs = {n: spec_for_path(n, tuple(p.shape), mesh, rules) for n, p in params.items()}
    whole = _undivided_heads(model, tp)
    tied = getattr(getattr(model, "config", None), "tie_word_embeddings", False)
    for n in specs:
        owner = n.rsplit(".", 2)[0]
        if owner in whole or (tied and n == "model.embed_tokens.weight"):
            specs[n] = _drop_tp(specs[n])
    for n, spec in list(specs.items()):
        if n.endswith(".weight") and spec[:1] == ("tp",) and n[:-len("weight")] + "bias" in specs:
            specs[n[:-len("weight")] + "bias"] = ("tp",)
    return specs


def tp_plan(model: nn.Module, mesh, rules=None) -> Dict[str, str]:
    """{module name: "colwise" | "rowwise"} for ``parallelize_module``: every
    module whose weight :func:`param_shardings` splits on tp. Raises on a tp
    split of a module other than ``nn.Linear``/``nn.Embedding`` (a quantized
    linear has no parallel style)."""
    plan = {}
    for n, spec in param_shardings(model, mesh, rules).items():
        if "tp" not in spec or not n.endswith(".weight") or len(spec) != 2:
            continue
        name = n[:-len(".weight")]
        mod = model.get_submodule(name)
        if isinstance(mod, nn.Embedding):
            plan[name] = "colwise"  # torch's Colwise splits an embedding's dim 1, the rule's tp dim
        elif isinstance(mod, nn.Linear):
            plan[name] = "colwise" if spec[0] == "tp" else "rowwise"
        else:
            raise TypeError(f"{name}: a {type(mod).__name__} cannot be split on tp")
    return plan


def all_reduce_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` in place over the tp ``group`` (issued at one rank too)."""
    dist.all_reduce(x, group=group)
    all_reduce_tp.launches += 1
    return x


def all_gather_tp(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(..., c) blocks of the last dim on the ``n`` ranks of ``group`` ->
    (..., n * c), in rank order (issued at one rank too)."""
    lead, c = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, c).contiguous()
    out = flat.new_empty((n * flat.shape[0], c))
    dist.all_gather_into_tensor(out, flat, group=group)
    all_gather_tp.launches += 1
    return out.view(n, -1, c).transpose(0, 1).reshape(*lead, n * c)


all_reduce_tp.launches = all_gather_tp.launches = 0


class ColumnShard(nn.Module):
    """Output rows ``[rank * n, (rank + 1) * n)`` of a whole ``nn.Linear``
    (views of its weight and bias); with ``gather`` (a tp group) the
    rows of every rank are all-gathered into whole outputs."""

    def __init__(self, linear: nn.Linear, rank: int, tp: int, gather=None):
        super().__init__()
        n = linear.out_features // tp
        rows = slice(rank * n, (rank + 1) * n)
        self.weight = nn.Parameter(linear.weight.detach()[rows], requires_grad=False)
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach()[rows], requires_grad=False)
        self.gather, self.tp = gather, tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight, self.bias)
        return y if self.gather is None else all_gather_tp(y, self.gather, self.tp)


class RowShard(nn.Module):
    """Input columns ``[rank * n, (rank + 1) * n)`` of a whole ``nn.Linear``
    (a strided view of its weight), the output summed over the tp
    ``group``; the bias joins the sum on the group's first rank only, so
    that at one rank this is the whole Linear, bit for bit."""

    def __init__(self, linear: nn.Linear, rank: int, tp: int, group):
        super().__init__()
        n = linear.in_features // tp
        self.weight = nn.Parameter(linear.weight.detach()[:, rank * n:(rank + 1) * n], requires_grad=False)
        self.bias = linear.bias if rank == 0 else None
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_tp(F.linear(x, self.weight, self.bias), self.group)


# a block's column-parallel linears, then its row-parallel one
TP_BLOCKS = ((("q_proj", "k_proj", "v_proj"), "o_proj"), (("q_proj", "k_proj", "v_proj"), "out_proj"),
             (("gate_proj", "up_proj"), "down_proj"), (("fc1",), "fc2"))


def tp_serving_model(model: nn.Module, mesh) -> Tuple[nn.Module, bool]:
    """(replica, cache split): this rank's tensor-parallel replica of a built
    ``HIComModel`` for serving (module docstring), and whether the decoder's
    attention, and so the KV cache, is split over the kv heads. The replica
    shares every tensor with ``model``: its slices are views, nothing is
    copied, and ``model`` itself is left as it was."""
    from ..models.qwen2 import DecoderAttention

    tp, rank, group = mesh["tp"].size(), mesh["tp"].get_local_rank(), mesh.get_group("tp")
    specs = param_shardings(model, mesh)
    shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    replica = copy.deepcopy(model, shared)

    def splits(name: str, mod: nn.Module, attr: str, dim: int) -> bool:
        lin = getattr(mod, attr)
        spec = specs.get(f"{name}.{attr}.weight", ())
        return type(lin) is nn.Linear and len(spec) == 2 and spec[dim] == "tp"

    blocks = []
    for name, mod in replica.named_modules():
        for cols, row in TP_BLOCKS:
            if all(hasattr(mod, a) for a in cols + (row,)):
                blocks.append((name, mod, cols, row,
                               all(splits(name, mod, a, 0) for a in cols) and splits(name, mod, row, 1)))
    decoder_attn = [split for _, mod, _, _, split in blocks if isinstance(mod, DecoderAttention)]
    cache_split = bool(decoder_attn) and all(decoder_attn)
    for name, mod, cols, row, split in blocks:
        if split and (cache_split or not isinstance(mod, DecoderAttention)):
            for a in cols:
                setattr(mod, a, ColumnShard(getattr(mod, a), rank, tp))
            setattr(mod, row, RowShard(getattr(mod, row), rank, tp, group))
    head = getattr(replica, "lm_head", None)
    if head is not None and specs.get("lm_head.weight", ())[:1] == ("tp",):
        replica.lm_head = ColumnShard(head, rank, tp, gather=group)
    return replica, cache_split


def fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The modules FSDP2 wraps before the root: every decoder, tower and guide-encoder layer."""
    from ..models.qwen2 import DecoderLayer
    from ..models.siglip import SiglipEncoderLayer

    return [m for m in model.modules() if isinstance(m, (DecoderLayer, SiglipEncoderLayer))]


def shard_model(model: nn.Module, mesh, rules=None) -> nn.Module:
    """Shard ``model`` in place over the (dp, fsdp, tp) ``mesh`` (module
    docstring): the tp plan of the rules, then FSDP2 over (dp, fsdp) per
    :func:`fsdp_units` and on the root, whose ``one_shot_forward`` gathers
    the root's own tensors (embeddings, norms, head, projector). Freeze what
    stays frozen first: FSDP2 reads ``requires_grad`` when it wraps."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

    plan = {}
    for name, style in tp_plan(model, mesh, rules).items():
        if style == "rowwise":
            plan[name] = RowwiseParallel()
        elif name in ("lm_head", "model.embed_tokens"):
            plan[name] = ColwiseParallel(output_layouts=Replicate())  # gathered: the loss takes whole rows
        else:
            plan[name] = ColwiseParallel()
    if plan:
        parallelize_module(model, mesh["tp"], plan)
    data = mesh["dp", "fsdp"]
    for unit in fsdp_units(model):
        fully_shard(unit, mesh=data)
    fully_shard(model, mesh=data)
    register_fsdp_forward_method(model, "one_shot_forward")
    return model


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage), or ``t`` itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def host_whole(t: torch.Tensor) -> Optional[torch.Tensor]:
    """The whole tensor of DTensor ``t`` copied into host memory on rank 0,
    None on the other ranks; every rank takes part in the gather, and the
    gathered copy leaves the device at once, so a walk over many tensors
    holds at most one whole tensor there. A plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    from ..utils import is_main_process

    if not isinstance(t, DTensor):
        return t
    whole = t.full_tensor()
    return whole.to("cpu", copy=True) if is_main_process() else None


def shard_batch_tree(batch: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """This rank's slice of every array leaf of a global batch (leading axis =
    batch; JAX ``batch_sharding``, ``P(("dp", "fsdp"))``), the rows
    ``data_rows`` gives its data coordinate, as ``iter_batches`` collates
    them; other leaves (``modal``, flags, the anyres plan) as they are."""
    rows = next(len(v) for v in batch.values() if hasattr(v, "shape") and len(v.shape))
    sl = data_rows(rows, *data_coordinate(mesh))
    return {k: v[sl] if hasattr(v, "shape") and len(v.shape) else v for k, v in batch.items()}


def constrain_batch_activation(x: torch.Tensor) -> torch.Tensor:
    """The JAX package pins an activation's batch axis to (dp, fsdp) with
    ``with_sharding_constraint``, an XLA layout hint; a rank here holds its
    rows as a plain tensor already, so this returns ``x``."""
    return x


def supports_host_offload(device) -> bool:
    """Whether ``device`` can take its optimizer state from host memory: a
    CUDA device copies it from pinned memory asynchronously; a CPU's tensors
    are host memory already."""
    device = torch.device(device)
    return device.type == "cpu" or (device.type == "cuda" and torch.cuda.is_available())


def host_pieces(numel: int, piece: int, device) -> List[torch.Tensor]:
    """Zeroed fp32 host memory for a flat buffer of ``numel`` elements that
    ``device`` reads, in pieces of ``piece`` elements (a power of two; the
    last piece holds the rest). For a CUDA device the pieces are pinned, and
    a failed pin raises: nothing falls back to pageable or device memory."""
    if piece <= 0 or piece & (piece - 1):
        raise ValueError(f"a host piece must be a power of two elements, not {piece}")
    device = torch.device(device)
    if not supports_host_offload(device):
        raise ValueError(f"{device} cannot take its optimizer state from host memory")
    pin = device.type == "cuda"
    pieces = []
    for start in range(0, numel, piece):
        t = torch.empty(min(piece, numel - start), dtype=torch.float32, pin_memory=pin)
        if pin and not t.is_pinned():
            raise RuntimeError("pinned host memory was not granted")
        pieces.append(t.zero_())
    return pieces


def pinned_bytes() -> int:
    """Bytes of pinned host memory handed out by PyTorch's host allocator now
    (its blocks as rounded; cached free blocks not counted)."""
    return int(torch.cuda.host_memory_stats()["active_bytes.current"])
