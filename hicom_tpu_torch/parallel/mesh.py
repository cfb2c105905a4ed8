"""The (dp, fsdp, tp) device mesh over the ranks of a process group.

Port of ``hicom_tpu/parallel/mesh.py`` onto
``torch.distributed.device_mesh.init_device_mesh``:

* ``dp``   — data parallel: parameters replicated, batch split;
* ``fsdp`` — data parallel with parameters and optimizer state sharded
  (FSDP2 ``fully_shard``, ZeRO-3);
* ``tp``   — tensor parallel over attention heads and MLP columns (DTensor
  ``parallelize_module``).

The batch is split over dp x fsdp (a rank's *data coordinate*); the tp ranks
of one data group read the same rows. Ranks are laid out as JAX lays out its
devices, tp innermost: rank r sits at (r // (fsdp*tp), r // tp % fsdp, r % tp).

One process drives one device. ``torchrun`` (``python -m
torch.distributed.run``) starts the processes and sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address;
:func:`init_distributed` joins them (NCCL on CUDA, gloo on the CPU). The mesh
is passed explicitly to whatever needs it: there is no ambient mesh like
JAX's ``with mesh:``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

MESH_AXES = ("dp", "fsdp", "tp")
DATA_AXES = ("dp", "fsdp")


def world_size() -> int:
    """The ranks of the default process group; 1 when none is initialised
    (where JAX counts ``len(jax.devices())``)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def under_torchrun() -> bool:
    """Whether this process was started by ``torchrun`` (its environment is set)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"))


def init_distributed(device, dp: Optional[int] = None, fsdp: int = 1, tp: int = 1) -> torch.device:
    """Join ``torchrun``'s process group (once per process) and return this
    rank's device: ``cuda:LOCAL_RANK`` (NCCL) for a CUDA ``device``, the CPU
    (gloo) for ``cpu``. Raises ``ValueError`` when a mesh of ``dp*fsdp*tp``
    ranks cannot be laid over the world (without ``torchrun`` the world is
    this one process): a multi-rank mesh never trains as one process."""
    device = torch.device(device)
    check_world(dp, fsdp, tp)
    if device.type == "cuda":
        from ..api import resolve_device

        resolve_device("cuda")  # raises without a card
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if not under_torchrun():
            raise ValueError("a mesh needs torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                             "MASTER_PORT): run under `python -m torch.distributed.run`")
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, **({"device_id": device} if device.type == "cuda" else {}))
    return device


def check_world(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1) -> None:
    """Raise ``ValueError`` when a (dp, fsdp, tp) mesh does not cover this
    process's world: ``torchrun``'s ``WORLD_SIZE``, else the one process."""
    world = int(os.environ["WORLD_SIZE"]) if under_torchrun() else 1
    try:
        _mesh_shape(world, dp, fsdp, tp)
    except ValueError as e:
        hint = "" if under_torchrun() else " (one process: start the ranks with `python -m torch.distributed.run`)"
        raise ValueError(f"{e}{hint}") from None


def _mesh_shape(n: int, dp: Optional[int], fsdp: int, tp: int):
    """JAX's rule: ``dp=None`` takes the ranks fsdp*tp leaves; the product must be the world."""
    if dp is None:
        if n % (fsdp * tp):
            raise ValueError(f"{n} ranks not divisible by fsdp*tp={fsdp * tp}")
        dp = n // (fsdp * tp)
    if dp * fsdp * tp != n:
        raise ValueError(f"dp*fsdp*tp={dp * fsdp * tp} != {n} ranks: the mesh must cover the world exactly")
    return dp, fsdp, tp


def create_mesh(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1, device_type: Optional[str] = None):
    """A (dp, fsdp, tp) ``DeviceMesh`` over the initialised process group;
    ``dp=None`` uses every rank fsdp*tp leaves. ``device_type`` defaults to
    ``cuda`` under NCCL, else ``cpu``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError("create_mesh needs an initialised process group (init_distributed)")
    shape = _mesh_shape(dist.get_world_size(), dp, fsdp, tp)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


def single_device_mesh(device_type: Optional[str] = None):
    """The (1, 1, 1) mesh of a one-rank group."""
    return create_mesh(1, 1, 1, device_type)


_WORLD_MESH = (None, None)  # (the default group it was made over, the mesh)


def world_mesh():
    """The (world, 1, 1) mesh over the default process group, made once for
    each group joined; None when no group is initialised."""
    global _WORLD_MESH
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if _WORLD_MESH[0] is not dist.group.WORLD:
        _WORLD_MESH = (dist.group.WORLD, create_mesh(dp=dist.get_world_size()))
    return _WORLD_MESH[1]


def flat_group(mesh, names: Sequence[str]):
    """(group, n, index) of this rank over mesh axes ``names``: the index is
    the flattened coordinate over the axes in the order given, as JAX counts
    it. The group is the one axis of more than one rank among them, or the
    default group when they cover every such axis of the mesh (its rank order
    is then the flattened coordinate); a
    :class:`~..ops.attention.SoloGroup` with no mesh or no axis of more than
    one rank."""
    from ..ops.attention import SoloGroup

    if mesh is None:
        return SoloGroup(), 1, 0
    n, idx = 1, 0
    for a in names:
        n, idx = n * mesh[a].size(), idx * mesh[a].size() + mesh[a].get_local_rank()
    split = [a for a in names if mesh[a].size() > 1]
    if not split:
        return SoloGroup(), 1, 0
    if len(split) == 1:
        return mesh.get_group(split[0]), n, idx
    if n != dist.get_world_size() or idx != dist.get_rank():
        raise ValueError(f"axes {tuple(names)} of a mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: name every "
                         "axis of more than one rank, in the mesh's order")
    return dist.group.WORLD, n, idx


def data_coordinate(mesh) -> tuple:
    """(index, count) of this rank's data group: dp x fsdp, tp innermost
    excluded. The iterator's ``process_index``/``process_count``."""
    if mesh is None:
        return 0, 1
    dp, fsdp = (mesh[a] for a in DATA_AXES)
    return dp.get_local_rank() * fsdp.size() + fsdp.get_local_rank(), dp.size() * fsdp.size()


def data_rows(rows: int, index: int, count: int) -> slice:
    """Data rank ``index`` of ``count``'s contiguous slice of a global batch of ``rows``."""
    if rows % count:
        raise ValueError(f"global batch {rows} not divisible by {count} data ranks")
    per = rows // count
    return slice(index * per, (index + 1) * per)


def all_reduce_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` in place over the data ranks (dp, then fsdp); the tp ranks of
    a group hold the same value and are not summed."""
    if mesh is not None:
        for axis in DATA_AXES:
            if mesh[axis].size() > 1:
                dist.all_reduce(t, group=mesh.get_group(axis))
    return t
