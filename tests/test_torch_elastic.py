"""Elastic recovery: losing ranks mid-run degrades the mesh, not the results
(tests/test_elastic.py's two recoverable cases on the port).  Four gloo
ranks run the job; the "survivors" are ranks 0 and 1, a mesh of their own
(its groups a ``new_group`` of the two), which reload the checkpointed
state and must reproduce the four-rank results."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sift_tpu.utils.checkpoint import load_keypoints as jax_load_keypoints
from sift_tpu_torch.parallel.ba_dist import shard_ba_problem, sharded_ba_step
from sift_tpu_torch.parallel.dist import sharded_match
from sift_tpu_torch.parallel.multihost import Earlier, MeshSpec, Step, run_steps
from sift_tpu_torch.utils.checkpoint import load_keypoints, save_keypoints
from sift_tpu_torch.utils.keypoints import Keypoints

RANKS = 4
SURVIVORS = MeshSpec(1, 2, ranks=(0, 1))


def descriptors():
    rng = np.random.default_rng(0)
    d1 = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    d2 = rng.integers(0, 256, (512, 128), dtype=np.uint8)
    return d1, np.ones(128, bool), d2, np.ones(512, bool)


def ba_args(n_shards):
    rng = np.random.default_rng(1)
    n_cams, n_pts = 4, 40
    pts = rng.uniform([-1, -1, 4], [1, 1, 6], (n_pts, 3))
    cams = np.zeros((n_cams, 6))
    cams[:, 3] = 0.1 * np.arange(n_cams)
    obs_cam = np.repeat(np.arange(n_cams, dtype=np.int32), n_pts)
    obs_pt = np.tile(np.arange(n_pts, dtype=np.int32), n_cams)
    obs_uv = np.concatenate([(pts + cams[c, 3:])[:, :2] / (pts + cams[c, 3:])[:, 2:] * 100.0 + 50.0
                             for c in range(n_cams)])
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    pts_noisy = pts + rng.normal(0, 0.01, pts.shape)
    return (cams, pts_noisy, obs_cam, obs_pt, obs_uv, n_shards, np.array([100.0, 100.0]),
            np.array([50.0, 50.0]), fixed)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn: the four-rank job, then the survivors' recovery."""
    d1, v1, d2, v2 = descriptors()
    state = str(tmp_path_factory.mktemp("elastic") / "state.npz")
    lanes = {f: np.zeros(512, np.float32) for f in ("x", "y", "size", "pori")}
    lanes.update(octave=np.zeros(512, np.int32), layer=np.zeros(512, np.int32), desc=d2, valid=v2)
    save_keypoints(state, Keypoints.from_numpy(lanes))
    steps = [
        Step(sharded_match, (d1, v1, d2, v2, MeshSpec(1, 4))),
        Step(load_keypoints, (state,), dict(device="cpu")),
        Step(sharded_match, (d1, v1, Earlier(1, "desc"), Earlier(1, "valid"), SURVIVORS)),
        Step(sharded_ba_step, (shard_ba_problem(*ba_args(4), device="cpu")[0], 1e-3,
                               MeshSpec(1, 4))),
        Step(sharded_ba_step, (shard_ba_problem(*ba_args(2), device="cpu")[0], 1e-3, SURVIVORS)),
    ]
    return state, run_steps(steps, RANKS)


def test_match_survives_rank_loss(ranks):
    _, res = ranks
    for r in range(RANKS):
        assert (res[r][2] is None) == (r not in SURVIVORS.ranks)
    idx4, acc4, b4, s4 = res[0][0].out
    for r in SURVIVORS.ranks:
        idx2, acc2, b2, s2 = res[r][2].out
        assert torch.equal(acc4, acc2) and torch.equal(b4, b2) and torch.equal(s4, s2)
        assert torch.equal(idx4[acc4], idx2[acc2])


def test_checkpoint_reloads_in_the_jax_package(ranks):
    """The state the survivors reload is the JAX package's layout too."""
    state, _ = ranks
    jkp = jax_load_keypoints(state)
    np.testing.assert_array_equal(np.asarray(jkp.desc), descriptors()[2])
    assert np.asarray(jkp.valid).all()


def test_ba_step_survives_rank_loss(ranks):
    _, res = ranks
    cams4, _, cost4 = res[0][3].out
    for r in SURVIVORS.ranks:
        cams2, _, cost2 = res[r][4].out
        assert abs(float(cost4) - float(cost2)) < 1e-3 * max(float(cost4), 1.0)
        np.testing.assert_allclose(cams4.numpy(), cams2.numpy(), atol=1e-5)
