"""The port's multi-view geometry (``sift_tpu_torch/models/geometry.py``)
against the JAX package's ``models/geometry.py``, on the CPU.

The two packages cannot share a random stream, so each RANSAC function is
held in two parts: the port's sampler (``sample_choice``: a CPU generator,
the same indices on any device) on its own, and the deterministic rest
(``*_with_samples``) fed the JAX package's own sample indices.  float64
cases run the JAX side with x64 on (the tests' default); float32 cases run
it with x64 off, the dtype users get.  Inputs are seeded numpy.  Each test
states its tolerance.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu.models.geometry as JG
import sift_tpu_torch.models.geometry as PG
import sift_tpu_torch.models.stitch as PS
from test_sfm import make_scene

# (numpy dtype, torch dtype, JAX x64 flag, tolerance for values of order 1)
DTYPES = {"float64": (np.float64, torch.float64, True, 1e-9),
          "float32": (np.float32, torch.float32, False, 2e-5)}


@partial(jax.jit, static_argnums=(1, 2))
def _jax_choice(valid, num_hypotheses, m, seed):
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return jax.random.choice(jax.random.PRNGKey(seed), valid.shape[0],
                             shape=(num_hypotheses, m), replace=True, p=probs)


def jax_draws(valid, num_hypotheses, m, seed=0):
    """The (K, m) indices the JAX package's RANSAC functions draw
    (``sift_tpu/models/geometry.py:134-137, 215-218``), as int64 on
    ``valid``'s device: a drop-in for ``sample_choice``."""
    v = valid.cpu().numpy() if torch.is_tensor(valid) else np.asarray(valid)
    with jax.enable_x64(False):
        idx = _jax_choice(jnp.asarray(v), num_hypotheses, m, int(seed))
    idx = torch.from_numpy(np.array(idx, np.int64))
    return idx.to(valid.device) if torch.is_tensor(valid) else idx


def jax_run(x64: bool, fn, *args):
    """``fn(*args)`` with JAX's x64 mode as given; numpy in and out."""
    with jax.enable_x64(x64):
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    return jax.tree_util.tree_map(np.asarray, out)


def _t(a, tdt):
    return torch.from_numpy(np.ascontiguousarray(a)).to(tdt)


def two_view(n=256, n_out=40, n_pad=32, seed=0, noise=0.3):
    """make_scene's cameras 0 and 1: normalized correspondences with
    ``n_out`` wrong partners and ``n_pad`` invalid lanes."""
    pts, poses, k, obs = make_scene(n_cams=2, seed=seed, noise=noise)
    d = [{int(r[1]): r[2:] for r in obs[obs[:, 0] == c]} for c in (0, 1)]
    common = sorted(set(d[0]) & set(d[1]))[:n]
    p1 = (np.array([d[0][i] for i in common]) - [320, 240]) / 500.0
    p2 = (np.array([d[1][i] for i in common]) - [320, 240]) / 500.0
    rng = np.random.default_rng(seed + 1)
    p2[:n_out] = rng.uniform(-0.6, 0.6, (n_out, 2))
    p1 = np.concatenate([p1, np.zeros((n_pad, 2))])
    p2 = np.concatenate([p2, np.zeros((n_pad, 2))])
    valid = np.arange(len(p1)) < len(common)
    return p1, p2, valid, poses[1]


def pnp_view(n=300, n_out=40, seed=0, noise=0.3):
    pts, poses, k, obs = make_scene(n_cams=3, seed=seed, noise=noise)
    o = obs[obs[:, 0] == 2][:n]
    x3 = pts[o[:, 1].astype(int)]
    x2 = (o[:, 2:] - [320, 240]) / 500.0
    x2[:n_out] = np.random.default_rng(seed + 2).uniform(-0.6, 0.6, (n_out, 2))
    x3 = np.concatenate([x3, np.zeros((20, 3))])
    x2 = np.concatenate([x2, np.zeros((20, 2))])
    return x3, x2, np.arange(len(x3)) < len(o), poses[2]


@pytest.mark.parametrize("dtype", DTYPES)
def test_rodrigues_matches_jax(dtype):
    """Angles from 0 (theta^2 < 1e-12, the series branch) to 3 rad.
    Tolerance: 1e-9 (float64) / 2e-5 (float32) per entry."""
    ndt, tdt, x64, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(40, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    ang = np.concatenate([[0.0, 1e-9, 5e-7, 1e-6], np.linspace(1e-3, 3.0, 36)])
    rv = (axes * ang[:, None]).astype(ndt)
    got = PG.rodrigues(_t(rv, tdt)).numpy()
    want = jax_run(x64, JG.rodrigues, rv)
    assert got.dtype == want.dtype == ndt
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got[0], np.eye(3), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rodrigues_derivatives_finite_at_zero(dtype):
    """Forward and reverse derivatives at rvec = 0 and at theta^2 just
    below 1e-12 are finite and equal JAX's jacfwd there.  Tolerance: 1e-9
    / 2e-5."""
    ndt, tdt, x64, tol = DTYPES[dtype]
    for rv in (np.zeros(3, ndt), np.array([3e-7, -2e-7, 5e-7], ndt)):
        fwd = torch.func.jacfwd(PG.rodrigues)(_t(rv, tdt)).numpy()
        rev = torch.func.jacrev(PG.rodrigues)(_t(rv, tdt)).numpy()
        want = jax_run(x64, jax.jacfwd(JG.rodrigues), rv)
        assert np.isfinite(fwd).all() and np.isfinite(rev).all()
        np.testing.assert_allclose(fwd, want, rtol=0, atol=tol)
        np.testing.assert_allclose(rev, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_project_points_matches_jax(dtype):
    """Batched cameras, points in front of them.  Tolerance: 1e-9 px
    (float64) / 2e-3 px (float32, pixels of order 500) and the same
    relative tolerance for the depth."""
    ndt, tdt, x64, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    rv = rng.normal(0, 0.2, (5, 3)).astype(ndt)
    tv = rng.normal(0, 0.3, (5, 3)).astype(ndt)
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], (5, 30, 3)).astype(ndt)
    fxy, cxy = np.array([500.0, 480.0], ndt), np.array([320.0, 240.0], ndt)
    got = [a.numpy() for a in PG.project_points(*(_t(a, tdt) for a in (rv, tv, pts, fxy, cxy)))]
    want = jax_run(x64, JG.project_points, rv, tv, pts, fxy, cxy)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol * 100)
    np.testing.assert_allclose(got[1], want[1], rtol=tol, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_triangulate_matches_jax(dtype):
    """One shared pose pair, and a pose per row against JAX's ``vmap`` of
    the row-at-a-time call (``sift_tpu/models/sfm.py:333-345``).
    Tolerance: 1e-7 (float64) / 2e-3 (float32) relative to the point's
    distance (a 4 x 4 null vector)."""
    ndt, tdt, x64, tol = DTYPES[dtype]
    p1, p2, valid, (r, t) = two_view(n_out=0, n_pad=0, noise=0.5)
    p1, p2, r, t = (a.astype(ndt) for a in (p1, p2, r, t))
    eye, zero = np.eye(3, dtype=ndt), np.zeros(3, ndt)
    got = PG.triangulate(*(_t(a, tdt) for a in (p1, p2, eye, zero, r, t))).numpy()
    want = jax_run(x64, JG.triangulate, p1, p2, eye, zero, r, t)
    scale = np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol * 100)

    rng = np.random.default_rng(2)
    r1s = np.asarray(jax_run(True, JG.rodrigues, rng.normal(0, 0.05, (len(p1), 3)))).astype(ndt)
    t1s = rng.normal(0, 0.1, (len(p1), 3)).astype(ndt)
    got = PG.triangulate(*(_t(a, tdt) for a in (p1, p2, r1s, t1s, r, t))).numpy()
    with jax.enable_x64(x64):
        want = np.asarray(jax.vmap(lambda a, b, ra, ta: JG.triangulate(
            a[None], b[None], ra, ta, jnp.asarray(r), jnp.asarray(t))[0])(
            *(jnp.asarray(a) for a in (p1, p2, r1s, t1s))))
    scale = np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol * 100)


def _eight_point_samples(n, k=256, seed=3):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n)[:8] for _ in range(k)])


@pytest.mark.parametrize("dtype", DTYPES)
def test_sampson_err2_matches_jax(dtype):
    """The squared Sampson distances of every point under 256 essential
    matrices.  Tolerance: float64 relative 2.5e-9 plus 1e-15; float32
    relative 1.25e-4 plus 2e-8 absolute (the epipolar residual is a sum of
    three unit-sized products that cancel, so its float32 rounding is a few
    1e-8 after squaring: 0.5% of the 2e-3 threshold squared)."""
    ndt, tdt, x64, tol = DTYPES[dtype]
    p1, p2, valid, _ = two_view(n_out=0, n_pad=0)
    idx = _eight_point_samples(len(p1))
    e = jax_run(True, JG._essential_from_8pt, p1[idx], p2[idx]).astype(ndt)
    p1, p2 = p1.astype(ndt), p2.astype(ndt)
    got = PG._sampson_err2(_t(e, tdt), _t(p1, tdt), _t(p2, tdt)).numpy()
    want = jax_run(x64, JG._sampson_err2, e, p1, p2)
    np.testing.assert_allclose(got, want, rtol=2.5 * tol, atol=1e-15 if x64 else 2e-8)


def test_essential_from_8pt_matches_jax_float64():
    """256 samples of 8 distinct points: E equal up to sign (the null
    vector's sign is arbitrary).  Tolerance: 1e-6 per entry: the normal
    equations square the 8 x 9 system's condition number, and the two
    packages form them in another order."""
    p1, p2, valid, _ = two_view(n_out=0, n_pad=0)
    idx = _eight_point_samples(len(p1))
    got = PG._essential_from_8pt(_t(p1[idx], torch.float64), _t(p2[idx], torch.float64)).numpy()
    want = jax_run(True, JG._essential_from_8pt, p1[idx], p2[idx])
    sign = np.sign((got * want).sum((1, 2)))[:, None, None]
    np.testing.assert_allclose(got * sign, want, rtol=0, atol=1e-6)


def test_essential_from_8pt_float32_fits_as_well_as_jax():
    """In float32 the 9 x 9 normal equations of an 8-point sample are too
    ill-conditioned for two implementations to agree entry by entry (the
    hypotheses of one sample differ by a few 1e-3 at the median), so the
    float32 hypotheses are held by what RANSAC reads from them: each
    sample's inlier count at the threshold of ``run_sfm``'s initial pair
    (2e-3).  Tolerance: the best count within 1 and the total over 512
    samples within 3% of the JAX package's (measured: 207 / 208 and
    -2.3%)."""
    p1, p2, valid, _ = two_view(n_out=40, n_pad=0)
    p1, p2 = p1.astype(np.float32), p2.astype(np.float32)
    idx = _eight_point_samples(len(p1), 512)
    e_p = PG._essential_from_8pt(_t(p1[idx], torch.float32), _t(p2[idx], torch.float32))
    c_p = (PG._sampson_err2(e_p, _t(p1, torch.float32), _t(p2, torch.float32)) < 4e-6).sum(1).numpy()
    e_j = jax_run(False, JG._essential_from_8pt, p1[idx], p2[idx])
    c_j = (jax_run(False, JG._sampson_err2, e_j, p1, p2) < 4e-6).sum(1)
    assert abs(int(c_p.max()) - int(c_j.max())) <= 1
    assert abs(int(c_p.sum()) - int(c_j.sum())) <= 0.03 * c_j.sum()


def _true_essential(r, t):
    t = t / np.linalg.norm(t)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    e = tx @ r
    return e / np.linalg.norm(e) * np.sqrt(2.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ransac_essential_with_jax_draws(dtype, monkeypatch):
    """``ransac_essential`` fed the JAX package's draws.  float64: the same
    inlier mask and count, E equal up to sign to 1e-8.  float32: the
    sampled hypotheses differ by float32's conditioning (see above), and
    so can the winner and whether the refit is kept (measured here: 216
    inliers for the port, 191 for the JAX package), so both are held to
    the truth instead: the count at least the JAX package's less 2%, and
    E (scaled to singular values 1, 1, 0) as close to the true essential
    matrix, up to sign, as the JAX package's or within 0.05 of it
    (measured: 0.004 for the port's refit, 0.084 for the JAX package's
    best sample)."""
    ndt, tdt, x64, tol = DTYPES[dtype]
    p1, p2, valid, (r_gt, t_gt) = two_view()
    p1, p2 = p1.astype(ndt), p2.astype(ndt)
    want = jax_run(x64, lambda a, b, v: JG.ransac_essential(a, b, v, 512, 2e-3, 7), p1, p2, valid)
    monkeypatch.setattr(PG, "sample_choice", jax_draws)
    e, mask, n = PG.ransac_essential(_t(p1, tdt), _t(p2, tdt), torch.from_numpy(valid), 512, 2e-3, 7)
    e = e.numpy()
    assert int(want[2]) > 0.7 * valid.sum()
    if x64:
        np.testing.assert_array_equal(mask.numpy(), want[1])
        assert int(n) == int(want[2])
        np.testing.assert_allclose(e * np.sign((e * want[0]).sum()), want[0], rtol=0, atol=1e-8)
    else:
        assert int(n) >= 0.98 * int(want[2])
        e_true = _true_essential(r_gt, t_gt)
        errs = [np.abs(est * np.sign((est * e_true).sum()) - e_true).max() for est in (e, want[0])]
        assert errs[0] <= max(errs[1], 0.05)


@pytest.mark.parametrize("dtype", DTYPES)
def test_recover_pose_matches_jax(dtype):
    """From the JAX package's essential matrix: the same rotation,
    translation and cheirality mask, which also match the ground truth.
    Tolerance: 1e-8 (float64) / 1e-4 (float32) per entry; mask exact;
    against the truth 2e-2 on R and 0.1 on the direction of t (0.3 px of
    noise and 40 wrong partners)."""
    ndt, tdt, x64, tol = DTYPES[dtype]
    p1, p2, valid, (r_gt, t_gt) = two_view()
    p1, p2 = p1.astype(ndt), p2.astype(ndt)
    e, inl, _ = jax_run(x64, lambda a, b, v: JG.ransac_essential(a, b, v, 512, 2e-3, 0),
                        p1, p2, valid)
    want = jax_run(x64, JG.recover_pose, e, p1, p2, inl)
    got = [a.numpy() for a in PG.recover_pose(_t(e, tdt), _t(p1, tdt), _t(p2, tdt),
                                              torch.from_numpy(inl))]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol * 5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=tol * 5)
    np.testing.assert_array_equal(got[2], want[2])
    assert np.abs(got[0] - r_gt).max() < 2e-2
    assert np.abs(got[1] - t_gt / np.linalg.norm(t_gt)).max() < 0.1


@pytest.mark.parametrize("dtype", DTYPES)
def test_ransac_pnp_with_jax_draws(dtype, monkeypatch):
    """``ransac_pnp`` fed the JAX package's draws: the same inlier mask and
    count, rvec and tvec.  Tolerance: float64: masks and counts exact,
    rvec and tvec 1e-8.  float32: the 12 x 12 DLT's normal equations are
    ill-conditioned (point coordinates up to 8 beside the homogeneous 1),
    so one sample's pose differs between the packages: the count within
    2%, the masks on 98% of the lanes, rvec and tvec 1e-2.  Against the
    truth: 1e-2 on R, 5e-2 on t (0.3 px of noise)."""
    ndt, tdt, x64, tol = DTYPES[dtype]
    x3, x2, valid, (r_gt, t_gt) = pnp_view()
    x3, x2 = x3.astype(ndt), x2.astype(ndt)
    want = jax_run(x64, lambda a, b, v: JG.ransac_pnp(a, b, v, 512, 8e-3, 11), x3, x2, valid)
    monkeypatch.setattr(PG, "sample_choice", jax_draws)
    got = [a.numpy() for a in PG.ransac_pnp(_t(x3, tdt), _t(x2, tdt), torch.from_numpy(valid),
                                            512, 8e-3, 11)]
    assert int(want[3]) > 0.8 * valid.sum()
    if x64:
        np.testing.assert_array_equal(got[2], want[2])
        assert int(got[3]) == int(want[3])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-8)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-8)
    else:
        assert (got[2] != want[2]).mean() <= 0.02
        assert abs(int(got[3]) - int(want[3])) <= 0.02 * int(want[3])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-2)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-2)
    r = PG.rodrigues(torch.from_numpy(got[0]).double()).numpy()
    assert np.abs(r - r_gt).max() < 1e-2 and np.abs(got[1] - t_gt).max() < 5e-2


def test_port_stream_recovers_the_two_view_geometry_and_pnp():
    """The port's own draws, float32 as in production: the JAX tests'
    bounds (``tests/test_sfm.py:55-120``) on their scenes."""
    p1, p2, valid, (r_gt, t_gt) = two_view(n=512, n_out=0, n_pad=0, noise=0.0)
    a, b, v = _t(p1, torch.float32), _t(p2, torch.float32), torch.from_numpy(valid)
    e, inl, cnt = PG.ransac_essential(a, b, v, 512)
    assert int(cnt) > 0.9 * valid.sum()
    r, t, _ = PG.recover_pose(e, a, b, inl)
    assert np.abs(r.numpy() - r_gt).max() < 2e-2
    assert np.abs(t.numpy() - t_gt / np.linalg.norm(t_gt)).max() < 2e-2
    x3, x2, valid, (r_gt, t_gt) = pnp_view(n=512, n_out=0, noise=0.0)
    rv, tv, _, cnt = PG.ransac_pnp(_t(x3, torch.float32), _t(x2, torch.float32),
                                   torch.from_numpy(valid), 512)
    assert int(cnt) > 0.9 * valid.sum()
    assert np.abs(PG.rodrigues(rv).numpy() - r_gt).max() < 1e-2
    assert np.abs(tv.numpy() - t_gt).max() < 2e-2


@pytest.mark.parametrize("m", [4, 6, 8])
def test_sample_choice_reproducible_and_uniform_over_valid_lanes(m):
    """Same seed, same indices; another seed, others; only valid lanes,
    each about equally often; with m = 4 it is ``sample_hypotheses``'s
    stream bit for bit.  Tolerance: indices exact; each lane's share
    within 15% of uniform over 8192 x m draws."""
    valid = torch.zeros(300, dtype=torch.bool)
    valid[::3] = True
    valid[250:] = False
    a = PG.sample_choice(valid, 8192, m, seed=5)
    assert a.shape == (8192, m) and a.dtype == torch.int64
    assert torch.equal(a, PG.sample_choice(valid, 8192, m, seed=5))
    assert not torch.equal(a, PG.sample_choice(valid, 8192, m, seed=6))
    assert valid[a].all()
    counts = np.bincount(a.flatten().numpy(), minlength=300)[valid.numpy()]
    assert np.abs(counts / counts.mean() - 1).max() < 0.15
    if m == 4:
        assert torch.equal(a, PS.sample_hypotheses(valid, 8192, seed=5))
    # no valid lane: every index is the last lane
    assert PG.sample_choice(torch.zeros(7, dtype=torch.bool), 3, m).eq(6).all()
