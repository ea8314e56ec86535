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

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu.models.sfm as JF
import sift_tpu_torch.models.geometry as PG
import sift_tpu_torch.models.sfm as PF
from sift_tpu_torch.utils import profiling
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


def _pairs_batch(copies=None):
    """Pairs of ``_pair``'s geometries, shifted and rescaled copies, for one
    call: ``(keypoints_uv, pair_matches)``.  By default six pairs at lane
    counts 64, 128 and 256, among them a near-static pair and one of under
    16 matches; with ``copies``, that many parallax pairs of 128 lanes."""
    uvs, pm = [], {}
    c = K[:2, 2]

    def add(case, shift=(0.0, 0.0), scale=1.0, rows=slice(None), twice=False):
        (a, b), m = _pair(case)
        a, b = (c + scale * (x - c) + np.asarray(shift) for x in (a, b))
        m = m[(0, 1)][rows]
        if twice:  # a second, shrunken copy beside it: 240 matches
            a, b = (np.concatenate([x, c + 0.6 * (x - c) + 40.0]) for x in (a, b))
            m = np.concatenate([m, m + len(m)])
        pm[(len(uvs), len(uvs) + 1)] = m
        uvs.extend([a, b])

    if copies:
        for n in range(copies):
            add("parallax", shift=(3.0 * n, -2.0 * n), scale=1.0 + 0.02 * n)
        return uvs, pm
    add("parallax")
    add("planar", shift=(7.0, -4.0))
    add("zero_baseline", scale=1.1)
    add("parallax", scale=0.9, rows=slice(0, 50))
    add("planar", twice=True)
    add("parallax", rows=slice(0, 10))
    return uvs, pm


@pytest.fixture(scope="module")
def verified_together():
    uvs, pm = _pairs_batch()
    stats = {}
    return uvs, pm, PF._geometric_verify(uvs, pm, K, seed=3, stats=stats, device="cpu"), stats


@pytest.mark.parametrize("pair", range(6))
def test_geometric_verify_batch_matches_each_pair_alone(verified_together, pair):
    """All pairs verified in one call (lane counts 64 / 128 / 256, a
    near-static pair, one of under 16 matches) give each pair what it gets
    verified alone: the kept matches, and with ``stats`` the model, GRIC
    and both inlier counts.  Tolerance: matches and counts exact, GRIC 1e-6
    relative."""
    uvs, pm, together, stats = verified_together
    key = list(pm)[pair]
    one_stats = {}
    alone = PF._geometric_verify(uvs, {key: pm[key]}, K, seed=3, stats=one_stats, device="cpu")
    assert (key in together) == (key in alone)
    if key in alone:
        np.testing.assert_array_equal(together[key], alone[key])
    assert (key in stats) == (key in one_stats)
    if key in one_stats:
        g, w = stats[key], one_stats[key]
        assert (g["model"], g["n"], g["e_inl"], g["h_inl"]) == (w["model"], w["n"], w["e_inl"],
                                                                 w["h_inl"])
        for s in ("gric_e", "gric_h"):
            assert g[s] == pytest.approx(w[s], rel=1e-6)
    assert list(together) == [p for p in pm if p in together]  # the pairs' order kept


def test_geometric_verify_waits_do_not_grow_with_pairs(monkeypatch):
    """The verification's solver calls (``eigh``, ``svd``: each a status
    read on the card), uploads and host reads are as many for 6 pairs of
    one lane count as for 2; its counters show one chain a model shared
    by every pair.  Tolerance: none."""
    calls = collections.Counter()

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    for name in ("eigh", "svd"):
        monkeypatch.setattr(torch.linalg, name, counted(name, getattr(torch.linalg, name)))
    for name in ("_upload_parts", "_f32", "_mask", "_host"):
        monkeypatch.setattr(PF, name, counted(name, getattr(PF, name)))

    def run(n):
        uvs, pm = _pairs_batch(copies=n)
        calls.clear()
        before = profiling.counters()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out = PF._geometric_verify(uvs, pm, K, seed=3, device="cpu")
        assert set(out) == set(pm)
        after = profiling.counters()
        return dict(calls), {c: after.get(c, 0) - before.get(c, 0)
                             for c in ("sfm.verify_pairs", "sfm.verify_chains")}

    (two, c2), (six, c6) = run(2), run(6)
    assert two == six == {"eigh": 3, "svd": 2, "_upload_parts": 1, "_host": 1}, (two, six)
    assert c2 == {"sfm.verify_pairs": 2, "sfm.verify_chains": 2}
    assert c6 == {"sfm.verify_pairs": 6, "sfm.verify_chains": 2}


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


# ---- the per-frame track index against the JAX package's loops ----------

def _track_graph(seed, n_frames=48, n_tracks=2000):
    """A seeded random track graph: each track 2-12 distinct frames around a
    random start (every frame's features a permutation of its ids), float32
    pixels per feature, points on about half the tracks, 30 frames
    registered in a random order."""
    rng = np.random.default_rng(seed)
    per_frame = [0] * n_frames
    tracks = []
    for _ in range(n_tracks):
        n = int(rng.integers(2, 13))
        lo = int(rng.integers(0, n_frames - n + 1))
        frames = sorted(rng.choice(np.arange(lo, min(n_frames, lo + 2 * n)), n, replace=False))
        g = []
        for f in frames:
            g.append((int(f), per_frame[f]))
            per_frame[f] += 1
        tracks.append(g)
    perm = [rng.permutation(n) for n in per_frame]
    track_obs = [sorted((f, int(perm[f][x])) for f, x in g) for g in tracks]
    uvs = [rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32) for n in per_frame]
    track_point = np.where(rng.uniform(size=n_tracks) < 0.5,
                           rng.permutation(n_tracks), -1).astype(np.int64)
    registered = [int(f) for f in rng.permutation(n_frames)[:30]]
    return track_obs, uvs, track_point, registered


def _jax_candidate_counts(track_obs, track_point, remaining):
    # sift_tpu/models/sfm.py:749-754 (run_sfm_from_matches)
    counts = {}
    for f in remaining:
        counts[f] = sum(
            1 for t, g in enumerate(track_obs)
            if track_point[t] >= 0 and f in dict(g)
        )
    return counts


def _jax_pnp_candidates(track_obs, track_point, f):
    # sift_tpu/models/sfm.py:260-264 (_register_frame)
    cands = []
    for t, g in enumerate(track_obs):
        gd = dict(g)
        if f in gd and track_point[t] >= 0:
            cands.append((t, gd[f]))
    return cands


def _jax_partners(track_obs, track_point, registered, uv_of, f):
    # sift_tpu/models/sfm.py:302-315 (_triangulate_new)
    new = []
    for t, g in enumerate(track_obs):
        gd = dict(g)
        if track_point[t] < 0 and f in gd:
            best_pf, best_d = -1, 0.0
            for rf in registered[:-1]:
                if rf not in gd:
                    continue
                d = float(np.linalg.norm(uv_of(rf, gd[rf]) - uv_of(f, gd[f])))
                if d > best_d:
                    best_pf, best_d = rf, d
            if best_pf >= 0 and best_d >= 0.75:
                new.append((t, best_pf, gd[best_pf], gd[f]))
    return new


def _jax_observations(track_obs, track_point, registered, uv_of):
    # sift_tpu/models/sfm.py:789-801 (_finish_global_ba; _ba_pass, 210-224,
    # is the same loop over set(registered))
    obs_cam, obs_pt, obs_uv = [], [], []
    for t, g in enumerate(track_obs):
        pid = track_point[t]
        if pid < 0:
            continue
        for f, feat in g:
            if f in registered:
                obs_cam.append(f)
                obs_pt.append(pid)
                obs_uv.append(uv_of(f, feat))
    return (np.asarray(obs_cam, np.int32), np.asarray(obs_pt, np.int32),
            np.asarray(obs_uv, np.float64))


def _jax_init_pair(track_obs, uv_of, n_frames):
    # sift_tpu/models/sfm.py:644-662 (run_sfm_from_matches)
    shared: dict[tuple[int, int], list] = {}
    for t, g in enumerate(track_obs):
        gd = dict(g)
        fs = sorted(gd)
        for ai in range(len(fs)):
            for bi in range(ai + 1, len(fs)):
                shared.setdefault((fs[ai], fs[bi]), []).append((t, gd))
    best_score = -1.0
    fa, fb = 0, min(1, n_frames - 1)
    for (i, j), lst in shared.items():
        if len(lst) < 16:
            continue
        disp = np.median(
            [np.linalg.norm(uv_of(i, gd[i]) - uv_of(j, gd[j])) for t, gd in lst]
        )
        score = disp * np.sqrt(len(lst))
        if score > best_score:
            best_score = score
            fa, fb = i, j
    return fa, fb


@pytest.mark.parametrize("what", ["counts", "pnp", "partners", "observations", "init_pair"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_track_index_matches_the_jax_loops(seed, what):
    """The port's per-frame track index on a random 48-frame, 2000-track
    graph against the JAX package's whole-track loops (copied above with
    their line numbers): the same candidate counts (kept up to date as
    tracks get points), PnP candidates in order, triangulation partners
    (ties to the first in registration order), BA observation rows and
    initial pair.  Tolerance: none."""
    track_obs, uvs, track_point, registered = _track_graph(seed)
    n_frames = len(uvs)

    def uv_of(f, feat):
        return uvs[f][feat]

    tix = PF._TrackIndex(track_obs, n_frames, keypoints_uv=uvs)
    assert list(tix) == track_obs
    if what == "counts":
        half = np.where(np.arange(len(track_point)) % 2 == 0, track_point, -1)
        tix.gained(np.nonzero(half >= 0)[0])
        assert PF._candidate_counts(range(n_frames), tix) == \
            _jax_candidate_counts(track_obs, half, range(n_frames))
        tix.gained(np.nonzero((track_point >= 0) & (half < 0))[0])
        assert PF._candidate_counts(range(n_frames), tix) == \
            _jax_candidate_counts(track_obs, track_point, range(n_frames))
    elif what == "pnp":
        for f in range(n_frames):
            ts, rows = tix.candidates(f, track_point)
            got = list(zip(ts.tolist(), tix.obs_feat[rows].tolist()))
            assert got == _jax_pnp_candidates(track_obs, track_point, f), f
    elif what == "partners":
        for n, f in enumerate(registered[1:], 2):
            reg = registered[:n]
            got = [(t, pf, int(tix.obs_feat[a]), int(tix.obs_feat[b]))
                   for t, pf, a, b in PF._partners(f, tix, track_point, reg, uv_of)]
            assert got == _jax_partners(track_obs, track_point, reg, uv_of, f), f
    elif what == "observations":
        got = PF._observations(tix, track_point, registered)
        want = _jax_observations(track_obs, track_point, registered, uv_of)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    else:
        assert PF._init_pair(tix, uv_of) == _jax_init_pair(track_obs, uv_of, n_frames)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_track_groups_are_the_union_finds(seed):
    """``_track_groups`` on random matches of 12 frames (pairs up to 3
    apart, chains, merges across pairs and a few matches that put two
    features of one frame in one track) is the JAX package's union-find
    (``_Tracks``) as its ``run_sfm_from_matches`` keeps the groups
    (``sift_tpu/models/sfm.py`` lines 627-634): the same tracks in the same
    order.  Tolerance: none."""
    rng = np.random.default_rng(seed)
    pm = {}
    for i in range(12):
        for j in range(i + 1, min(i + 4, 12)):
            n = int(rng.integers(0, 300))
            pm[(i, j)] = np.stack([rng.integers(0, 400, n), rng.integers(0, 400, n)], 1)
    tr = JF._Tracks()
    for (i, j), m in pm.items():
        for a, b in m:
            tr.union((i, int(a)), (j, int(b)))
    for min_len in (2, 3):
        want = [sorted(g) for g in tr.groups()
                if len(g) >= min_len and len({f for f, _ in g}) == len(g)]
        assert PF._track_groups(pm, min_len) == want
    assert PF._track_groups({}, 2) == []
