"""The port's point-sharded bundle adjustment on gloo ranks against the JAX
package: ``shard_ba_problem``'s arrays exactly, ``sharded_cost`` and one
``sharded_ba_step`` in float64 within 1e-9 relative at kp = 2 and 4, and
``sharded_ba_solve`` against the port's single-process ``ba_solve`` under
tests/test_ba_dist.py's gates.  The rank pool is spawned once."""

from __future__ import annotations

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.parallel import ba_dist as jax_ba_dist
from sift_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sift_tpu_torch.models.ba import ba_problem_from_numpy, ba_solve, build_obs_by_point
from sift_tpu_torch.parallel.ba_dist import (
    shard_ba_problem,
    sharded_ba_solve,
    sharded_ba_step,
    sharded_cost,
)
from sift_tpu_torch.parallel.multihost import MeshSpec, Step, run_steps

RANKS = 4
SHARDS = (2, 4)
FXY = np.array([500.0, 500.0])
CXY = np.array([320.0, 240.0])


def scene():
    """tests/test_ba_dist.py's problem: 5 cameras of tests/test_sfm.py's
    scene, 0.3 px noise, cameras 2-4 perturbed by 0.03, points by 0.05,
    cameras 0-1 fixed."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_sfm import make_scene

    pts, poses, _, obs = make_scene(n_cams=5, noise=0.3, seed=3)
    rng = np.random.default_rng(7)
    cams = np.zeros((5, 6))
    for i, (r, t) in enumerate(poses):
        th = np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))
        ax = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
        cams[i, :3] = ax / max(np.linalg.norm(ax), 1e-12) * th
        cams[i, 3:] = t
    cams[2:] += rng.normal(0, 0.03, cams[2:].shape)
    pts = pts + rng.normal(0, 0.05, pts.shape)
    fixed = np.zeros(5, bool)
    fixed[:2] = True
    return cams, pts, obs[:, 0].astype(np.int32), obs[:, 1].astype(np.int32), obs[:, 2:], fixed


def args(n_shards):
    cams, pts, obs_cam, obs_pt, obs_uv, fixed = scene()
    return cams, pts, obs_cam, obs_pt, obs_uv, n_shards, FXY, CXY, fixed


def port_problem(n_shards, dtype):
    return shard_ba_problem(*args(n_shards), dtype=dtype, device="cpu")[0]


@pytest.fixture(scope="module")
def ranks():
    """One spawn: per kp width the float64 cost and step, and the float32
    solve."""
    steps, where = [], {}
    for n in SHARDS:
        mesh = MeshSpec(1, n, None if n == RANKS else tuple(range(n)))
        sp64 = port_problem(n, torch.float64)
        where["cost", n] = len(steps)
        steps.append(Step(sharded_cost, (sp64, mesh)))
        where["step", n] = len(steps)
        steps.append(Step(sharded_ba_step, (sp64, 1e-3, mesh)))
        where["solve", n] = len(steps)
        steps.append(Step(sharded_ba_solve, (port_problem(n, torch.float32), mesh), dict(iters=12)))
    return where, run_steps(steps, RANKS)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_shard_ba_problem_equals_jax(n_shards):
    sp, (shard_of, local_idx) = shard_ba_problem(*args(n_shards), device="cpu")
    jsp, (jshard_of, jlocal_idx) = jax_ba_dist.shard_ba_problem(*args(n_shards))
    assert set(sp) == set(jsp)
    for k, v in jsp.items():
        np.testing.assert_array_equal(sp[k].numpy(), np.asarray(v), err_msg=k)
        assert sp[k].dtype.is_floating_point == np.issubdtype(np.asarray(v).dtype, np.floating)
    np.testing.assert_array_equal(shard_of, jshard_of)
    np.testing.assert_array_equal(local_idx, jlocal_idx)


def close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-9 * scale, err_msg=what)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_cost_and_step_equal_jax_float64(ranks, n_shards):
    where, res = ranks
    jsp, _ = jax_ba_dist.shard_ba_problem(*args(n_shards), dtype=jnp.float64)
    mesh = jax_make_mesh(data=1, kp=n_shards)
    jcost = float(jax_ba_dist.sharded_cost(jsp, mesh))
    jcams, jpts, jcost0 = jax_ba_dist.sharded_ba_step(jsp, 1e-3, mesh)
    for r in range(n_shards):
        assert abs(float(res[r][where["cost", n_shards]].out) - jcost) <= 1e-9 * jcost
        cams, pts, cost0 = res[r][where["step", n_shards]].out
        assert abs(float(cost0) - float(jcost0)) <= 1e-9 * float(jcost0)
        close(cams, jcams, "cams")
        close(pts, jpts, "points")


@pytest.mark.parametrize("n_shards", SHARDS)
def test_solve_matches_single_process(ranks, n_shards):
    """tests/test_ba_dist.py's gates against the port's ba_solve, float32."""
    where, res = ranks
    cams, pts, obs_cam, obs_pt, obs_uv, fixed = scene()
    pr = ba_problem_from_numpy(dict(
        cams=cams.astype(np.float32), points=pts.astype(np.float32), obs_cam=obs_cam,
        obs_pt=obs_pt, obs_uv=obs_uv.astype(np.float32), obs_mask=np.ones(len(obs_cam), bool),
        obs_by_point=build_obs_by_point(obs_pt, len(pts)), fxy=FXY.astype(np.float32),
        cxy=CXY.astype(np.float32), fixed_cams=fixed), "cpu")
    cams_ref, _, info_ref = ba_solve(pr, iters=12)
    sp_out, info = res[0][where["solve", n_shards]].out
    cost0, ref = info["cost_trace"][0], info_ref["cost_trace"]
    assert abs(cost0 - ref[0]) < 1e-2 * cost0
    assert info["cost_trace"][-1] < ref[0] * 0.05
    assert abs(info["cost_trace"][-1] - ref[-1]) / max(ref[-1], 1e-6) < 0.05
    np.testing.assert_allclose(sp_out["cams"].numpy(), cams_ref.numpy(), atol=5e-3)
    for r in range(1, n_shards):
        assert torch.equal(res[r][where["solve", n_shards]].out[0]["cams"], sp_out["cams"])
