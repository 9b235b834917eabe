"""The process-global data mesh of the proving pipeline.

Counterpart of proof_systems_tpu/parallel/auto.py. Where the JAX package
builds a ('data',) mesh over the chips one process sees, the port follows
PyTorch's idiom: one process per device in the default process group
(`torch.distributed.init_process_group`; NCCL on cards, gloo on the CPU),
the rank's device `cuda:LOCAL_RANK` under NCCL and `cpu` under gloo. While
that group is initialised, the prover's MSMs shard their batch or their
points over the ranks (ops/msm.py) and its quotient walk shards the d8
rows (prover.py); row-sharded NTTs are parallel/ntt.py.

Unlike the JAX package's, the mesh exists for a world of one too, so that
one card runs every sharded route. PST_MESH=0 turns the mesh off without
leaving the group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class Mesh:
    """The default process group seen from one rank."""

    rank: int
    size: int
    device: torch.device
    group: object = field(default=None, compare=False, repr=False)


_mesh: Mesh | None = None


def rank_device(backend: str) -> torch.device:
    """A rank's device: `cuda:LOCAL_RANK` under NCCL, else the CPU."""
    if backend == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cpu")


def data_mesh() -> Mesh | None:
    """The mesh of the initialised default group (of any size), or None
    when no group is initialised or PST_MESH=0."""
    global _mesh
    import torch.distributed as dist

    if os.environ.get("PST_MESH", "1") == "0":
        return None
    if not (dist.is_available() and dist.is_initialized()):
        _mesh = None
        return None
    group = dist.group.WORLD
    if _mesh is None or _mesh.group is not group:
        _mesh = Mesh(dist.get_rank(), dist.get_world_size(),
                     rank_device(dist.get_backend()), group)
    return _mesh


def reset_mesh() -> None:
    """Forget the cached mesh (after the group is destroyed or replaced)."""
    global _mesh
    _mesh = None


def mesh_for(t: torch.Tensor) -> Mesh | None:
    """The mesh when `t` lies on its device type; a tensor on another
    device while a mesh is up is a caller's error, not a quiet
    single-device run."""
    mesh = data_mesh()
    if mesh is not None and t.device.type != mesh.device.type:
        raise ValueError(f"tensor on {t.device}, the mesh's ranks are on {mesh.device}")
    return mesh


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(size, *t.shape): every rank's `t` in rank order, on every rank.
    int32 and int64 only (gloo refuses uint32); `t` is made contiguous."""
    import torch.distributed as dist

    t = t.contiguous()
    out = torch.empty((mesh.size * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    # concatenated along dim 0 (all_gather_single is the newer name)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=mesh.group)
    return out.view(mesh.size, *t.shape)
