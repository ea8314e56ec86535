"""The port's incremental SfM (``sift_tpu_torch/models/sfm.py``) against the
JAX package's ``models/sfm.py``, on the CPU: the counterpart of every case
of ``tests/test_sfm.py`` and ``tests/test_sfm_verify.py``, and the slice
as a whole through ``run_sfm_from_matches``.

RANSAC is held as in ``test_torch_geometry.py``: fed the JAX package's own
draws (``sample_choice`` monkeypatched), the port must reach the JAX
package's decisions; on its own stream it must meet the JAX tests' bounds.
The JAX side runs with x64 off, the float32 its users get.  Each test
states its tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu.models.sfm as JF
import sift_tpu_torch.models.geometry as PG
import sift_tpu_torch.models.sfm as PF
from test_sfm import make_scene
from test_sfm_verify import K, _project, _rot_y
from test_torch_geometry import jax_draws

torch.set_num_threads(2)


def _pair(case):
    """The three pair geometries of ``tests/test_sfm_verify.py``, with its
    noise (0.3 px) and 24 rerouted (wrong) matches of 120."""
    if case == "parallax":
        pts = np.random.default_rng(1).uniform([-2, -2, 3], [2, 2, 9], (120, 3))
        uv1 = _project(pts, np.eye(3), np.zeros(3))
        uv2 = _project(pts, _rot_y(0.05), np.array([-0.4, 0.02, 0.0]))
    elif case == "planar":
        rng = np.random.default_rng(2)
        pts = np.concatenate([rng.uniform([-2, -2], [2, 2], (120, 2)), np.full((120, 1), 5.0)], 1)
        uv1 = _project(pts, np.eye(3), np.zeros(3))
        uv2 = _project(pts, _rot_y(0.08), np.array([-0.5, 0.0, 0.05]))
    else:
        pts = np.random.default_rng(3).uniform([-2, -2, 3], [2, 2, 9], (120, 3))
        uv1 = _project(pts, np.eye(3), np.zeros(3))
        uv2 = uv1.copy()
    rng = np.random.default_rng(0)
    n, n_bad = len(uv1), 24
    uv1 = uv1 + rng.normal(0, 0.3, uv1.shape)
    uv2 = uv2 + rng.normal(0, 0.3, uv2.shape)
    m = np.stack([np.arange(n), np.arange(n)], 1)
    bad = np.arange(n - n_bad, n)
    m[bad, 1] = rng.permutation(bad)
    while (m[bad, 1] == bad).any():
        m[bad, 1] = rng.permutation(bad)
    return [uv1, uv2], {(0, 1): m}


def _fractions(kept, n=120, n_bad=24):
    good = sum(1 for a, b in kept if a == b)
    return good / (n - n_bad), (len(kept) - good) / n_bad


# (good kept at least, wrong kept at most): tests/test_sfm_verify.py's bounds
VERIFY_BOUNDS = {"parallax": (0.85, 0.15), "planar": (0.85, 0.15), "zero_baseline": (0.9, 0.1)}


@pytest.mark.parametrize("case", VERIFY_BOUNDS)
def test_geometric_verify_on_the_port_stream(case):
    """GRIC H-vs-E verification keeps the right matches and drops the
    wrong ones on the port's own draws.  Bounds: the JAX tests'."""
    uvs, pm = _pair(case)
    kept = PF._geometric_verify(uvs, pm, K, seed=3, device="cpu").get((0, 1), np.zeros((0, 2)))
    good, bad = _fractions(kept)
    lo, hi = VERIFY_BOUNDS[case]
    assert good > lo and bad < hi, (good, bad)


@pytest.mark.parametrize("case", VERIFY_BOUNDS)
def test_geometric_verify_with_jax_draws(case, monkeypatch):
    """Fed the JAX package's draws, the same model choice (GRIC) and the
    same kept matches but for a few on a model's 2-sigma band edge.
    Tolerance: the kept sets differ by at most 2 of 120 matches (float32
    hypotheses differ between the packages at their conditioning), the
    GRIC scores by 2% and the inlier counts by 3."""
    uvs, pm = _pair(case)
    want_stats, got_stats = {}, {}
    with jax.enable_x64(False):
        want = JF._geometric_verify(uvs, pm, K, seed=3, stats=want_stats)
    monkeypatch.setattr(PG, "sample_choice", jax_draws)
    got = PF._geometric_verify(uvs, pm, K, seed=3, stats=got_stats, device="cpu")
    assert set(got) == set(want)
    a = {tuple(r) for r in got[(0, 1)]}
    b = {tuple(r) for r in want[(0, 1)]}
    assert len(a ^ b) <= 2, (len(a), len(b))
    assert set(got_stats) == set(want_stats)
    for key, w in want_stats.items():
        g = got_stats[key]
        assert g["model"] == w["model"] and g["n"] == w["n"]
        for s in ("gric_e", "gric_h"):
            assert g[s] == pytest.approx(w[s], rel=0.02)
        for s in ("e_inl", "h_inl"):
            assert abs(g[s] - w[s]) <= 3


def test_geometric_verify_small_pairs_pass_through():
    """Fewer than 16 matches: kept as they are, no RANSAC.  Tolerance:
    none."""
    uv = np.random.default_rng(4).uniform(0, 100, (10, 2))
    m = np.stack([np.arange(10), np.arange(10)], 1)
    out = PF._geometric_verify([uv, uv + 5], {(0, 1): m}, K, seed=0, device="cpu")
    np.testing.assert_array_equal(out[(0, 1)], m)


def test_loop_closure_candidates_match_jax():
    """``tests/test_sfm_verify.py``'s retrieval case: the same pairs as the
    JAX package (the same numpy), only frames >= min_gap apart, the
    revisit proposed, no cross-appearance pair.  Tolerance: none."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(40, 128)).astype(np.float32)
    b = rng.normal(size=(40, 128)).astype(np.float32)
    descs = [np.clip((a if (i < 6 or i == 10) else b) + rng.normal(0, 0.05, a.shape), -3, 3)
             * 40 + 120 for i in range(12)]
    for min_sim in (0.95, 0.5):
        got = PF.loop_closure_candidates(descs, min_gap=8, min_sim=min_sim)
        assert got == JF.loop_closure_candidates(descs, min_gap=8, min_sim=min_sim)
    cands = PF.loop_closure_candidates(descs, min_gap=8, min_sim=0.95)
    assert all(j - i >= 8 for i, j in cands)
    assert any(j == 10 and i < 6 for i, j in cands), cands
    for i, j in cands:
        assert (i < 6 or i == 10) == (j < 6 or j == 10), (i, j)


def _centers(p):
    r = PG.rodrigues(torch.as_tensor(p[:, :3], dtype=torch.float64)).numpy()
    return -np.einsum("nji,nj->ni", r, p[:, 3:])


def test_pose_graph_relax_closes_the_drifted_chain():
    """``tests/test_sfm.py``'s drifted chain (pass 2 revisits pass 1 with
    30% scale drift, five closures): the JAX package's relaxed poses, the
    closure gaps shrunk by more than 5x, pass 1's steps within 0.02 of
    0.1.  Tolerance: 1e-4 on the poses (both solve the float32 residuals
    in float64 steps; the Jacobians come from another autodiff)."""
    n = 20
    poses = np.zeros((n, 6))
    for i in range(10):
        poses[i, 3:] = -np.array([0.1 * i, 0.0, 0.0])
    for i in range(10, 20):
        poses[i, 3:] = -np.array([0.9 - 0.13 * (i - 10), 0.0, 0.0])
    closures = [(i, 19 - i, np.eye(3)) for i in range(4, 9)]
    out = PF.pose_graph_relax(poses, list(range(n)), closures, n_iters=25)
    with jax.enable_x64(False):
        want = JF.pose_graph_relax(poses, list(range(n)), closures, n_iters=25)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-4)
    c0, c1 = _centers(poses), _centers(out)
    gap0 = np.mean([np.linalg.norm(c0[i] - c0[19 - i]) for i in range(4, 9)])
    gap1 = np.mean([np.linalg.norm(c1[i] - c1[19 - i]) for i in range(4, 9)])
    assert gap1 < gap0 / 5.0, (gap0, gap1)
    steps = np.linalg.norm(np.diff(c1[:9], axis=0), axis=1)
    assert np.all(np.abs(steps - 0.1) < 0.02), steps
    # nothing to relax: a copy
    assert np.array_equal(PF.pose_graph_relax(poses, list(range(n)), []), poses)


def test_fill_unregistered_by_interpolation():
    """``tests/test_sfm.py``'s gaps: interior frames lerp, trailing frames
    extrapolate the last step, a frame beyond ``max_dist`` stays as it
    was; the JAX package's poses.  Tolerance: 1e-5 on the centres (float32
    rotations), 1e-12 on the poses against the JAX package's."""
    n = 12
    poses = np.zeros((n, 6))
    poses[:, 3:] = -np.stack([0.5 * np.arange(n), np.zeros(n), np.zeros(n)], 1)
    poses[:, :3] = np.random.default_rng(0).normal(0, 0.01, (n, 3))
    reg = [0, 1, 2, 5, 6, 7]
    out, filled = PF._fill_unregistered_by_interpolation(poses, reg, n, max_dist=3, device="cpu")
    with jax.enable_x64(False):
        want, want_filled = JF._fill_unregistered_by_interpolation(poses, reg, n, max_dist=3)
    assert filled == want_filled and set(filled) == {3, 4, 8, 9, 10}
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(out[11], poses[11])
    poses[:, :3] = 0.0
    out, _ = PF._fill_unregistered_by_interpolation(poses, reg, n, max_dist=3, device="cpu")
    c = _centers(out)
    np.testing.assert_allclose(c[[3, 4, 9], 0], [1.5, 2.0, 4.5], atol=1e-5)


def test_so3_log_and_relative_rotation_match_jax():
    """``_so3_log`` from the identity (its series branch) to 3 rad, with
    finite derivatives at the identity; ``_relative_rotation`` (numpy on
    both sides).  Tolerance: 1e-12 (float64)."""
    rng = np.random.default_rng(5)
    axes = rng.normal(size=(30, 3))
    rv = axes / np.linalg.norm(axes, axis=1, keepdims=True) * np.linspace(0, 3.0, 30)[:, None]
    r = PG.rodrigues(torch.from_numpy(rv)).numpy()
    got = PF._so3_log(torch.from_numpy(r)).numpy()
    want = np.asarray(JF._so3_log(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[1:], rv[1:], rtol=0, atol=1e-9)
    jac = torch.func.jacrev(PF._so3_log)(torch.eye(3, dtype=torch.float64)).numpy()
    assert np.isfinite(jac).all()
    np.testing.assert_allclose(jac, np.asarray(jax.jacrev(JF._so3_log)(jnp.eye(3))), atol=1e-12)
    q1 = rng.uniform(-0.5, 0.5, (60, 2))
    q2 = q1 + rng.normal(0, 1e-3, q1.shape)
    np.testing.assert_array_equal(PF._relative_rotation(q1, q2), JF._relative_rotation(q1, q2))


def sfm_scene():
    """``tests/test_sfm.py::test_incremental_sfm_ate``'s scene: 8 cameras,
    500 points, 0.2 px of noise, consecutive-pair matches."""
    pts, poses, k, obs = make_scene(n_pts=500, n_cams=8, noise=0.2, seed=5)
    feats = [[] for _ in range(8)]
    feat_of = {}
    for ci, pi, u, v in obs:
        feat_of[(int(ci), int(pi))] = len(feats[int(ci)])
        feats[int(ci)].append([u, v])
    pm = {(i, i + 1): np.asarray([[feat_of[(i, p)], feat_of[(i + 1, p)]] for p in range(len(pts))
                                  if (i, p) in feat_of and (i + 1, p) in feat_of])
          for i in range(7)}
    return [np.asarray(f) for f in feats], pm, k, np.stack([-(r.T @ t) for r, t in poses])


def _ate(centers, centers_gt):
    """The JAX test's similarity-aligned ATE."""
    mu_g, mu_e = centers_gt.mean(0), centers.mean(0)
    gc, ec = centers_gt - mu_g, centers - mu_e
    u, s, vt = np.linalg.svd(gc.T @ ec / len(gc))
    d = np.diag([1, 1, np.sign(np.linalg.det(u @ vt))])
    rot = u @ d @ vt
    scale = np.trace(np.diag(s) @ d) / (ec ** 2).sum() * len(gc)
    aligned = scale * ec @ rot.T + mu_g
    return np.sqrt(((aligned - centers_gt) ** 2).sum(1).mean())


def _init_pair(mod, monkeypatch):
    """Record the initial pair (the two cameras the global BA fixes)."""
    seen = []
    fn = mod._finish_global_ba

    def run(*a, **kw):
        seen.append((a[6], a[7]))
        return fn(*a, **kw)
    monkeypatch.setattr(mod, "_finish_global_ba", run)
    return seen


def test_run_sfm_from_matches_with_jax_draws(monkeypatch):
    """The slice as a whole, fed the JAX package's draws: the same tracks
    (track -> point), initial pair and registered frames, the same number
    of points and observations, and poses and points within tolerance.
    Tolerance: 1e-3 on the poses, 1e-2 on the points (depths 4-8 units;
    float32 solves in both, the BA's sums in another order)."""
    uvs, pm, k, _ = sfm_scene()
    want_pair = _init_pair(JF, monkeypatch)
    got_pair = _init_pair(PF, monkeypatch)
    with jax.enable_x64(False):
        want = JF.run_sfm_from_matches(uvs, dict(pm), k, ba_iters=20)
    monkeypatch.setattr(PG, "sample_choice", jax_draws)
    got = PF.run_sfm_from_matches(uvs, dict(pm), k, ba_iters=20, device="cpu")
    assert got_pair == want_pair
    np.testing.assert_array_equal(got.track_point, want.track_point)
    for key in ("registered", "n_tracks", "n_points", "n_obs", "pruned_obs"):
        assert got.info[key] == want.info[key], key
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.points, want.points, rtol=0, atol=1e-2)


def test_run_sfm_from_matches_on_the_port_stream():
    """The port's own draws: the JAX test's bounds (more than 200 points,
    similarity-aligned ATE under 0.05 x the span), every frame
    registered, finite poses and points."""
    uvs, pm, k, centers_gt = sfm_scene()
    res = PF.run_sfm_from_matches(uvs, pm, k, ba_iters=20, device="cpu")
    assert res.info["n_points"] > 200
    assert res.info["registered"] == list(range(8))
    assert np.isfinite(res.poses).all() and np.isfinite(res.points).all()
    span = np.linalg.norm(centers_gt.max(0) - centers_gt.min(0))
    ate = _ate(_centers(res.poses), centers_gt)
    assert ate < 0.05 * span, (ate, span)


def test_ba_pass_matches_jax():
    """``_ba_pass`` (the windowed BA of ``run_sfm_from_matches``'s
    ``windowed_ba_every``) on the scene's true tracks, cameras 2-7 and
    every point perturbed, frame 7 not yet registered (it must not move):
    the JAX package's poses and points.  Tolerance: 1e-3 on poses and
    points (float32 in both, the BA's sums in another order)."""
    uvs, pm, k, _ = sfm_scene()
    pts, poses, _, obs = make_scene(n_pts=500, n_cams=8, noise=0.2, seed=5)
    rng = np.random.default_rng(9)
    cams = np.zeros((8, 6))
    for i, (r, t) in enumerate(poses):
        cams[i, :3] = PF._so3_log(torch.from_numpy(r)).numpy()
        cams[i, 3:] = t
    cams[2:] += rng.normal(0, 0.01, (6, 6))
    # (frame, feature index) per point, in the order sfm_scene numbers them
    count = [0] * 8
    tracks = {}
    for ci, pi, _, _ in obs:
        tracks.setdefault(int(pi), []).append((int(ci), count[int(ci)]))
        count[int(ci)] += 1
    ids = sorted(p for p, g in tracks.items() if len(g) >= 2)
    track_obs = [sorted(tracks[p]) for p in ids]
    track_point = np.arange(len(ids))
    points = list(pts[ids] + rng.normal(0, 0.02, (len(ids), 3)))
    registered = list(range(7))
    fxy, cxy = np.array([k[0, 0], k[1, 1]]), np.array([k[0, 2], k[1, 2]])
    args = (8, cams, points, track_obs, track_point, registered, 0, 1, fxy, cxy,
            lambda f, i: uvs[f][i], 5)
    got_c, got_p = PF._ba_pass(*args, device="cpu")
    with jax.enable_x64(False):
        want_c, want_p = JF._ba_pass(*args)
    np.testing.assert_array_equal(got_c[7], cams[7].astype(np.float32))  # fixed: float32 round trip
    assert np.abs(got_c[2:7] - cams[2:7]).max() > 1e-3  # the pass moved the free cameras
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.asarray(got_p), np.asarray(want_p), rtol=0, atol=1e-3)
