"""Device mesh construction and the collectives the sharded functions use.

Counterpart of ``sift_tpu/parallel/mesh.py``.  The JAX package runs one
program over a ``Mesh`` of devices; the port runs SPMD, one process per
rank joined by ``torch.distributed`` (``parallel/multihost.py`` brings the
group up).  The mesh has the same two axes:

  - ``data``: batch of images / frames (pure data parallel)
  - ``kp``:   keypoint/descriptor shards (matching, BA blocks)

Every sharded function of ``parallel/`` is called on every rank of its mesh
with the same arguments, the full global arrays, as the JAX functions take
them; each rank slices its own shard, and each returns the same global
result on every rank (what a replicated output is in the JAX package).
``psum`` over an axis is ``all_reduce`` (SUM) on that axis's group, and
``all_gather`` is ``all_gather`` below.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from sift_tpu_torch.utils.numerics import resolve_device

AXES = ("data", "kp")


def make_mesh(data: int = 1, kp: int = 1, device="cuda", ranks=None) -> DeviceMesh:
    """(data, kp) mesh over all ranks of the process group, or over
    ``ranks`` (the port of the JAX ``devices`` argument: a mesh of some
    ranks, e.g. the survivors of a failure).

    Called on every rank of the group, also by ranks outside ``ranks``
    (creating the mesh's groups is collective); such a rank gets a mesh
    whose ``get_coordinate()`` is None and calls no sharded function on it.
    The mesh's groups take the process group's backend (``multihost``
    chooses it).  Needs a process group (``multihost.initialize`` or
    ``multihost.spawn``).
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call parallel.multihost.initialize "
                           "or run the ranks through parallel.multihost.spawn")
    n = data * kp
    world = dist.get_world_size()
    if ranks is None:
        if n != world:
            raise ValueError(f"need {n} ranks, have {world}")
        return init_device_mesh(dev.type, (data, kp), mesh_dim_names=AXES)
    ranks = [int(r) for r in ranks]
    if len(ranks) != n or len(set(ranks)) != n or not all(0 <= r < world for r in ranks):
        raise ValueError(f"need {n} distinct ranks of {world}, got {ranks}")
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(data, kp), mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum of ``t`` over the ranks along ``axis`` (``jax.lax.psum``)."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=mesh.get_group(axis))
    return out


# Sum types for all_gather: floats travel as their bit patterns.
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """(n, *t.shape): ``t`` of each rank along ``axis``, in axis order
    (``jax.lax.all_gather``).

    Written as a SUM ``all_reduce`` over a zero-filled slot buffer, each
    rank filling its own slot: gloo, which the ranks that share one card
    use, sums CUDA tensors but need not gather them.  Floats are summed as
    their integer bit patterns, booleans and bytes as int32, so the gather
    is exact (-0.0 and NaN payloads survive) on every backend.
    """
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if t.dtype in _BITS:
        bits = t.contiguous().view(_BITS[t.dtype])
    elif t.dtype in (torch.bool, torch.uint8):
        bits = t.to(torch.int32)
    else:
        bits = t
    slots = torch.zeros((n, *t.shape), dtype=bits.dtype, device=t.device)
    slots[i] = bits
    dist.all_reduce(slots, group=mesh.get_group(axis))
    if t.dtype in _BITS:
        return slots.view(t.dtype)
    return slots.to(t.dtype) if slots.dtype != t.dtype else slots
