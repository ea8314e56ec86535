"""The port's ``parallel/mesh.py`` and ``parallel/multihost.py`` on the CPU:
bring-up (a no-op without settings, torchrun's environment, a coordinator
URL), the fleet barrier, the spawned rank pool with its meshes (whole,
2 x 2, and a mesh of some ranks), and the collectives the sharded
functions use: an exact gather (-0.0 and NaN payloads survive), the
all-reduce, and both on the axes of a 2 x 2 mesh.  The JAX package's
``make_mesh`` fixes the axis names and the size check."""

from __future__ import annotations

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sift_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sift_tpu_torch import kernels
from sift_tpu_torch.parallel import mesh as M
from sift_tpu_torch.parallel import multihost as MH
from sift_tpu_torch.parallel.multihost import MeshSpec, Step, run_steps

RANKS = 4
# float32 bit patterns that a float sum would not keep: -0.0, a NaN with a
# payload, the largest float, the smallest subnormal.
ODD = np.array([0x80000000, 0x7FC01234, 0x7F7FFFFF, 0x00000001], np.uint32).view(np.float32)


@pytest.fixture
def no_launcher_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def world_of_one(tmp_path, no_launcher_env):
    """A one-rank gloo group in this process, through a coordinator URL."""
    MH.initialize(f"file://{tmp_path}/rendezvous", num_processes=1, process_id=0, backend="gloo")
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    """One spawn: meshes and collectives on 4 ranks."""
    odd = torch.from_numpy(ODD.copy())
    whole, square, pair = MeshSpec(1, 4), MeshSpec(2, 2), MeshSpec(1, 2, ranks=(2, 3))
    steps = [
        Step(MH.fleet_barrier),
        Step(M.axis_index, (whole, "kp")), Step(M.axis_size, (whole, "kp")),
        Step(M.axis_index, (square, "data")), Step(M.axis_index, (square, "kp")),
        Step(M.axis_index, (pair, "kp")),
        Step(M.all_gather, (odd, whole, "kp")),
        Step(M.all_gather, (torch.tensor([True, False, True]), square, "data")),
        Step(M.all_gather, (torch.arange(6, dtype=torch.float64).reshape(2, 3), square, "kp")),
        Step(M.all_reduce, (torch.ones(3, dtype=torch.int64), whole, "kp")),
        Step(M.all_reduce, (torch.full((2,), 0.5), square, "data")),
        Step(M.all_gather, (torch.tensor([7], dtype=torch.uint8), pair, "kp")),
    ]
    return run_steps(steps, RANKS, device="cpu")


def test_initialize_without_settings_is_a_noop(no_launcher_env):
    MH.initialize()
    MH.initialize()
    assert not dist.is_initialized()
    assert MH.fleet_barrier() == 1


def test_initialize_needs_the_process_count(no_launcher_env):
    with pytest.raises(ValueError, match="num_processes"):
        MH.initialize("localhost:1")
    assert not dist.is_initialized()


def test_initialize_from_a_coordinator_url(world_of_one):
    assert dist.is_initialized() and dist.get_world_size() == 1
    MH.initialize("file:///nonexistent/other", num_processes=2, process_id=1)  # idempotent
    assert dist.get_world_size() == 1
    assert MH.fleet_barrier() == 1


def test_initialize_from_torchrun_environment(monkeypatch, no_launcher_env):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1",
                     RANK="0").items():
        monkeypatch.setenv(k, v)
    MH.initialize(backend="gloo")
    try:
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
    finally:
        dist.destroy_process_group()


def test_make_mesh_checks_the_rank_count_as_jax_checks_devices(world_of_one):
    """JAX raises for more devices than it has; the port for a mesh whose
    size is not the group's, and the axis names are the same."""
    with pytest.raises(ValueError, match="need 8"):
        jax_make_mesh(data=2, kp=4, devices=[object()] * 4)
    with pytest.raises(ValueError, match="need 2 ranks, have 1"):
        M.make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="distinct ranks"):
        M.make_mesh(1, 1, device="cpu", ranks=(3,))
    mesh = M.make_mesh(1, 1, device="cpu")
    assert mesh.mesh_dim_names == jax_make_mesh(1, 1).axis_names
    assert M.axis_size(mesh, "kp") == 1 and M.mesh_device(mesh) == torch.device("cpu")


def test_make_mesh_needs_a_process_group(no_launcher_env):
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_mesh(1, 1, device="cpu")


def test_fleet_barrier_counts_ranks(ranks):
    assert [r[0].out for r in ranks] == [RANKS] * RANKS


@pytest.mark.parametrize("step,want", [
    (1, [0, 1, 2, 3]), (2, [4] * 4), (3, [0, 0, 1, 1]), (4, [0, 1, 0, 1]), (5, [None, None, 0, 1]),
], ids=["whole-kp", "whole-size", "square-data", "square-kp", "pair-kp"])
def test_mesh_coordinates(ranks, step, want):
    assert [None if r[step] is None else r[step].out for r in ranks] == want


def test_all_gather_is_exact(ranks):
    for r in ranks:
        got = r[6].out
        assert got.shape == (RANKS, 4) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.tile(ODD.view(np.uint32), (RANKS, 1)))
        assert torch.equal(r[7].out, torch.tensor([[True, False, True]] * 2))
        assert torch.equal(r[8].out, torch.arange(6, dtype=torch.float64).reshape(1, 2, 3)
                           .expand(2, 2, 3))


def test_all_reduce_sums_over_the_axis(ranks):
    for r in ranks:
        assert torch.equal(r[9].out, torch.full((3,), RANKS, dtype=torch.int64))
        assert torch.equal(r[10].out, torch.ones(2))


def test_a_mesh_of_some_ranks(ranks):
    assert [r[11] is None for r in ranks] == [True, True, False, False]
    for r in ranks[2:]:
        assert torch.equal(r[11].out, torch.tensor([[7], [7]], dtype=torch.uint8))
        assert r[11].launches == dict.fromkeys(kernels.launch_counts(), 0)
        assert r[11].peak_bytes == 0


@pytest.mark.parametrize("call", ["spawn", "run_steps"])
def test_rank_launchers_run_on_the_card_unless_asked(monkeypatch, call):
    """``spawn`` and ``run_steps`` take the card by default, as every entry
    point does: without one they raise the no-CUDA error before any rank is
    started."""
    import inspect

    launcher = getattr(MH, call)
    assert inspect.signature(launcher).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(torch.multiprocessing, "start_processes",
                        lambda *a, **k: started.append(a))
    arg = MH.fleet_barrier if call == "spawn" else [Step(MH.fleet_barrier)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher(arg, RANKS)
    assert not started
