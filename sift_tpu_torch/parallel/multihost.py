"""Process-group bring-up, fleet health and the rank launcher.

Counterpart of ``sift_tpu/parallel/multihost.py``.  The JAX package wires
hosts into one system with ``jax.distributed.initialize`` and simulates a
fleet on one host with virtual CPU devices; the port runs one process per
rank, joined by ``torch.distributed``:

  - ``initialize(...)``: idempotent bring-up of the process group from a
    coordinator address or torchrun's environment; without either, a
    single-process no-op.
  - ``fleet_barrier()``: the liveness probe, an ``all_reduce`` of one per
    rank; a dead rank surfaces as the group's timeout here rather than a
    hang deep in a collective.
  - ``spawn(fn, nprocs, ...)``: run ``fn`` on ``nprocs`` new processes of
    one group on this host (the simulated fleet; on one card the ranks
    share it through gloo) and return each rank's result; on the card
    unless the caller passes ``device="cpu"``.  ``run_steps``
    runs a list of calls on every rank through ``spawn``, with the meshes
    built in each rank, and reports each call's result, seconds, kernel
    launches and peak device memory per rank.
  - Recovery: on failure, relaunch with the surviving ranks and resume from
    checkpoints (utils/checkpoint.py); ``tests/test_torch_elastic.py``
    exercises the degrade-and-recompute path on a mesh of survivors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from sift_tpu_torch import kernels
from sift_tpu_torch.utils.keypoints import Keypoints

TIMEOUT_S = 600.0


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> None:
    """Idempotent ``torch.distributed.init_process_group``.

    ``coordinator_address``: ``host:port`` of rank 0 (or an init URL such
    as ``file:///path``), with ``num_processes`` and ``process_id``.
    Without it, torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``; with neither, a single-process no-op.
    ``backend``: NCCL where there is a card (one rank per card), else gloo.
    """
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(env["RANK"]) if process_id is None else process_id
    if coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator address needs num_processes and process_id")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)) % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def fleet_barrier() -> int:
    """All-rank liveness probe: the sum of one per rank.

    Returns the world size (1 without a process group).  The JAX package's
    counts devices; the port's counts ranks, one per card (ranks that share
    a card count once each).
    """
    if not dist.is_initialized():
        return 1
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    one = torch.ones(1, dtype=torch.int32, device=dev)
    dist.all_reduce(one)
    return int(one.item())


def spawn(fn: Callable, nprocs: int, args: tuple = (), device="cuda",
          backend: str | None = None) -> list:
    """``fn(*args)`` on ranks 0 .. nprocs-1 of a new process group, each a
    new process of this host; returns the ranks' results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path, so it lives
    in a module that a fresh interpreter imports) and so is each result.
    ``device``: ``"cuda"``, the default (rank r on card r mod the card
    count; the kernels are built here first, so the ranks only load them),
    or ``"cpu"`` (each rank uses one CPU thread); without a card the default
    raises before any rank is spawned, as every entry point does.
    ``backend``: NCCL for CUDA, gloo for the CPU; ranks that share one card
    need gloo, since NCCL takes one rank per card.  A rank that fails fails
    the call: no rank falls back to another device or backend.
    """
    from sift_tpu_torch.utils.numerics import resolve_device

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if backend == "nccl" and nprocs > torch.cuda.device_count():
            raise ValueError(f"NCCL takes one rank per card: {nprocs} ranks, "
                             f"{torch.cuda.device_count()} cards; use backend='gloo'")
        kernels.build([p.stem for p in sorted(kernels.CSRC.glob("*.cu"))])
    with tempfile.TemporaryDirectory(prefix="sift_ranks_") as tmp:
        # The call goes through a file: a payload larger than a pipe's buffer
        # would hold each start until that rank has imported torch.
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        torch.multiprocessing.start_processes(
            _rank_main, args=(tmp, nprocs, dev.type, backend), nprocs=nprocs, join=True,
            start_method="spawn")
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _rank_main(rank, tmp, nprocs, device_type, backend):
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=nprocs,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        out = fn(*args)
        dist.barrier()  # ranks that finished early must not tear the group down under the rest
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh that each rank builds with ``mesh.make_mesh`` (a mesh holds
    process groups, which cannot be pickled)."""

    data: int = 1
    kp: int = 1
    ranks: tuple | None = None


@dataclasses.dataclass(frozen=True)
class Earlier:
    """The result of step ``step`` on the same rank (or its ``field``)."""

    step: int
    field: str | None = None


@dataclasses.dataclass
class Step:
    """One call that ``run_steps`` makes on every rank: ``fn(*args,
    **kwargs)`` with each ``MeshSpec`` in them built into a mesh and each
    ``Earlier`` replaced by that result.  A rank outside a step's mesh
    skips the step."""

    fn: Callable
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StepResult:
    """One step on one rank: its result on the host, the seconds from
    before the call to after a synchronize, the kernel launches, and the
    peak device memory in bytes (0 on the CPU)."""

    out: Any
    seconds: float
    launches: dict
    peak_bytes: int


def to_host(x):
    """``x`` with every tensor moved to the CPU (tensors, Keypoints, dicts,
    lists and tuples of them)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, Keypoints):
        return x.map(lambda a: a.detach().cpu())
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def run_steps(steps: list[Step], nprocs: int, device="cuda", backend: str | None = None):
    """Run ``steps`` in order on ``nprocs`` spawned ranks (``spawn``, on the
    card unless ``device="cpu"``); returns, per rank, a list with a
    ``StepResult`` per step (None where the rank was outside the step's
    mesh)."""
    from sift_tpu_torch.utils.numerics import resolve_device

    device_type = resolve_device(device).type
    return spawn(_run_steps_rank, nprocs, args=(steps, device_type), device=device_type,
                 backend=backend)


def _run_steps_rank(steps: list[Step], device: str):
    from sift_tpu_torch.parallel.mesh import make_mesh

    cuda = device == "cuda"
    meshes, outs, report = {}, [], []

    def resolve(a):
        if isinstance(a, MeshSpec):
            if a not in meshes:  # every rank builds it: its groups are collective
                meshes[a] = make_mesh(a.data, a.kp, device, ranks=a.ranks)
            return meshes[a]
        if isinstance(a, Earlier):
            out = outs[a.step]
            return out if a.field is None else getattr(out, a.field)
        if isinstance(a, (list, tuple)):
            return type(a)(resolve(v) for v in a)
        if isinstance(a, dict):
            return {k: resolve(v) for k, v in a.items()}
        return a

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for st in steps:
        args, kwargs = resolve(st.args), resolve(st.kwargs)
        specs = [a for a in (*st.args, *st.kwargs.values()) if isinstance(a, MeshSpec)]
        if any(meshes[s].get_coordinate() is None for s in specs):
            outs.append(None)
            report.append(None)
            continue
        kernels.reset_launch_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        out = st.fn(*args, **kwargs)
        sync()
        seconds = time.perf_counter() - t0
        outs.append(out)
        report.append(StepResult(
            out=to_host(out), seconds=seconds,
            launches=kernels.launch_counts(),
            peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0))
    return report
