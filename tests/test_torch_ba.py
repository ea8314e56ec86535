"""The port's Schur-complement bundle adjustment (``sift_tpu_torch/models/
ba.py``) against the JAX package's ``models/ba.py``, on the CPU.

One problem, ``tests/test_sfm.py``'s ``make_scene`` (5 cameras, 400
points, 0.3 px of noise, the last three cameras and every point
perturbed), built as the JAX package's ``BAProblem`` and carried across
by ``ba_problem_from_numpy``.  float64 cases run the JAX side with x64 on,
float32 cases with x64 off (what users get).  The port sums per camera and
per point in another order than the JAX package's scatter (a GEMM, a
table), so the two agree to rounding.  Each test states its tolerance.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu.models.ba as JB
import sift_tpu_torch.models.ba as PB
from test_sfm import make_scene

DTYPES = {"float64": (np.float64, torch.float64, True), "float32": (np.float32, torch.float32, False)}


def _cams(poses):
    cams = np.zeros((len(poses), 6))
    for i, (r, t) in enumerate(poses):
        th = np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))
        ax = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
        cams[i, :3] = ax / max(np.linalg.norm(ax), 1e-12) * th
        cams[i, 3:] = t
    return cams


def problem_arrays(seed=3):
    """The JAX test's BA problem (``tests/test_sfm.py:123-158``) as numpy:
    the fields of its ``BAProblem``, and the true cameras."""
    pts, poses, k, obs = make_scene(n_cams=5, noise=0.3, seed=seed)
    cams = _cams(poses)
    rng = np.random.default_rng(7)
    cams_noisy = cams.copy()
    cams_noisy[2:] += rng.normal(0, 0.03, cams_noisy[2:].shape)
    obs_pt = obs[:, 1].astype(np.int32)
    fixed = np.zeros(5, bool)
    fixed[:2] = True
    return dict(cams=cams_noisy, points=pts + rng.normal(0, 0.05, pts.shape),
                obs_cam=obs[:, 0].astype(np.int32), obs_pt=obs_pt, obs_uv=obs[:, 2:],
                obs_mask=np.ones(len(obs), bool),
                obs_by_point=JB.build_obs_by_point(obs_pt, len(pts)),
                fxy=np.array([500.0, 500.0]), cxy=np.array([320.0, 240.0]),
                fixed_cams=fixed), cams


def both(dtype, mask_every=None):
    """(JAX BAProblem, the port's BAProblem from its fields as numpy)."""
    ndt, tdt, x64 = DTYPES[dtype]
    a, _ = problem_arrays()
    if mask_every:
        a["obs_mask"][::mask_every] = False
    with jax.enable_x64(x64):
        jp = JB.BAProblem(**{k: jnp.asarray(v.astype(ndt) if v.dtype.kind == "f" else v)
                             for k, v in a.items()})
    fields = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    return jp, PB.ba_problem_from_numpy(fields, "cpu")


def test_build_obs_by_point_matches_jax():
    """Points observed 0-6 times, with and without a cap.  Tolerance:
    none."""
    obs_pt = np.random.default_rng(0).integers(0, 50, 200).astype(np.int32)
    for cap in (None, 3):
        got = PB.build_obs_by_point(obs_pt, 55, cap)
        want = JB.build_obs_by_point(obs_pt, 55, cap)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ba_problem_from_numpy(dtype):
    """Every field of the JAX package's problem, on the CPU: floats in the
    JAX problem's dtype, indices int64, masks bool.  Tolerance: none."""
    jp, pp = both(dtype)
    tdt = DTYPES[dtype][1]
    for f in dataclasses.fields(jp):
        got, want = getattr(pp, f.name), np.asarray(getattr(jp, f.name))
        assert got.device.type == "cpu"
        assert got.dtype == {"f": tdt, "i": torch.int64, "b": torch.bool}[want.dtype.kind]
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobians_match_jax(dtype):
    """Residuals and both Jacobians per observation, cameras 0 and 1 at
    rvec = 0 exactly (the series branch of ``rodrigues``), and a masked
    observation in every seventh.  Tolerance: 1e-9 (float64) / 2e-4
    (float32) relative to each array's largest entry."""
    ndt, tdt, x64 = DTYPES[dtype]
    jp, pp = both(dtype, mask_every=7)
    got = PB._jacobians(pp, pp.cams, pp.points)
    with jax.enable_x64(x64):
        want = JB._jacobians(jp, jp.cams, jp.points)
    tol = 1e-9 if x64 else 2e-4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * np.abs(w).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_schur_reduce_matches_jax(dtype):
    """The reduced camera system S (the port's (C, 6, C, 6) layout against
    the JAX package's (C, C, 6, 6)), its right-hand side and the pieces of
    the back-substitution, on the JAX package's Jacobians.  Tolerance:
    1e-9 (float64) / 1e-4 (float32) relative to each array's largest
    entry."""
    ndt, tdt, x64 = DTYPES[dtype]
    jp, pp = both(dtype)
    with jax.enable_x64(x64):
        r, jc, jp_ = JB._jacobians(jp, jp.cams, jp.points)
        want = [np.asarray(a) for a in JB._schur_reduce(jp, jc, jp_, r, jnp.asarray(1e-3, ndt))]
    got = [a.numpy() for a in PB._schur_reduce(
        pp, *(torch.from_numpy(np.asarray(a)) for a in (jc, jp_, r)), torch.tensor(1e-3, dtype=tdt))]
    got[0] = got[0].transpose(0, 2, 1, 3)
    tol = 1e-9 if x64 else 1e-4
    for g, w, name in zip(got, want, ("S", "rhs", "V_inv", "W", "cam_of", "g_p")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("huber", [None, 3.0], ids=["l2", "huber3"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ba_step_matches_jax(dtype, huber):
    """One LM step's candidate cameras and points.  Tolerance: 1e-8
    (float64) / 1e-3 (float32: a 30 x 30 solve of float32 sums) absolute;
    the step itself is of order 0.05."""
    ndt, tdt, x64 = DTYPES[dtype]
    jp, pp = both(dtype)
    with jax.enable_x64(x64):
        want = [np.asarray(a) for a in JB.ba_step(jp, jnp.asarray(1e-3, ndt), huber)]
    got = [a.numpy() for a in PB.ba_step(pp, torch.tensor(1e-3, dtype=tdt), huber)]
    tol = 1e-8 if x64 else 1e-3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    assert np.abs(got[0] - np.asarray(jp.cams)).max() > 1e-3  # the step moved


@pytest.mark.parametrize("huber", [None, 3.0], ids=["l2", "huber3"])
def test_ba_solve_matches_jax(huber):
    """``ba_solve``'s cost trace and its result, float64, 15 iterations.
    Tolerance: relative 1e-7 on the trace, 1e-7 absolute on cameras and
    points.  The damping it ends with is not compared: once the cost has
    converged, a step changes it by rounding only, and accept or reject
    (halve or quadruple the damping) follows those last bits."""
    jp, pp = both("float64")
    cams, pts, info = PB.ba_solve(pp, 15, huber_delta=huber)
    with jax.enable_x64(True):
        jcams, jpts, jinfo = JB.ba_solve(jp, 15, huber_delta=huber)
    np.testing.assert_allclose(info["cost_trace"], jinfo["cost_trace"], rtol=1e-7)
    np.testing.assert_allclose(cams.numpy(), np.asarray(jcams), rtol=0, atol=1e-7)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0, atol=1e-7)


def test_ba_converges_and_is_deterministic():
    """float32, as ``run_sfm`` runs it: the JAX test's bounds
    (``tests/test_sfm.py:123-158``: cost down 20x, RMS reprojection error
    under 0.6 px, the free cameras' translations within 0.05 of the
    truth); the JAX package's own float32 trace within 1% at every
    iteration; and the same bits from a second run (the sums have a fixed
    order)."""
    jp, pp = both("float32")
    _, cams_true = problem_arrays()
    cams, pts, info = PB.ba_solve(pp, 15)
    trace = info["cost_trace"]
    assert trace[-1] < trace[0] * 0.05
    assert np.sqrt(trace[-1] / (2 * pp.obs_cam.shape[0])) < 0.6
    assert np.abs(cams.numpy()[2:, 3:] - cams_true[2:, 3:]).max() < 0.05
    with jax.enable_x64(False):
        _, _, jinfo = JB.ba_solve(jp, 15)
    np.testing.assert_allclose(trace, jinfo["cost_trace"], rtol=1e-2)
    cams2, pts2, info2 = PB.ba_solve(pp, 15)
    assert info2["cost_trace"] == trace
    assert torch.equal(cams2, cams) and torch.equal(pts2, pts)


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
def test_schur_sums_on_the_cpu_are_the_jax_scatter_at_any_thread_count(threads):
    """On the CPU the sums per camera (U, g_c, sum_p Y_pa g_p) and the
    camera system (sum_p Y_pa W_pb^T, each 6 x 6 block a sum of three
    products) are scatters in row order: the JAX package's ``segment_sum``
    / ``.at[].add`` order, which ``np.add.at`` reproduces, bit for bit at
    every thread count.  A CPU GEMM splits its
    inner dimension over threads, and its bits followed the thread count
    (the loop-49 SfM stream at seed 0 read 3.87% ATE at one thread and
    14.05% at four).  Float32, Huber-weighted Jacobians, lambda 1e-3.
    Tolerance: none."""
    _, pp = both("float32")
    r, jc, jp = PB._jacobians(pp, pp.cams, pp.points)
    sw = PB._huber_sqrt_weights(r, 3.0)
    r, jc, jp = r * sw[:, None], jc * sw[:, None, None], jp * sw[:, None, None]
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        u, g_c, yw, yg, v_inv, w, cam_of, g_p = PB._schur_parts(
            pp, jc, jp, r, torch.tensor(1e-3, dtype=torch.float32))
    finally:
        torch.set_num_threads(old)
    c, (p, f) = pp.cams.shape[0], pp.obs_by_point.shape

    def scatter(idx, rows, n):
        out = np.zeros((n, rows.shape[1]), np.float32)
        np.add.at(out, idx, rows)
        return out

    cams = pp.obs_cam.numpy()
    want_u = scatter(cams, torch.einsum("oki,okj->oij", jc, jc).reshape(-1, 36).numpy(), c)
    want_g = -scatter(cams, torch.einsum("oki,ok->oi", jc, r).numpy(), c)
    y = torch.einsum("pfij,pjk->pfik", w, v_inv)
    ya, wb = y.numpy()[:, :, None, :, None, :], w.numpy()[:, None, :, None, :, :]
    blocks = (ya[..., 0] * wb[..., 0] + ya[..., 1] * wb[..., 1]
              + ya[..., 2] * wb[..., 2]).reshape(-1, 36)  # (P, F, F, 6, 6): pads too
    pair = (cam_of[:, :, None] * c + cam_of[:, None, :]).reshape(-1).numpy()
    want_yw = scatter(pair, blocks, c * c).reshape(c, c, 6, 6).transpose(0, 2, 1, 3)
    want_yg = scatter(cam_of.reshape(-1).numpy(),
                      torch.einsum("pfij,pj->pfi", y, g_p).reshape(-1, 6).numpy(), c)
    assert pp.obs_cam.shape[0] > 1500 and (p, f) == (400, 5)
    np.testing.assert_array_equal(u.reshape(c, 36).numpy(), want_u)
    np.testing.assert_array_equal(g_c.numpy(), want_g)
    np.testing.assert_array_equal(yw.numpy(), want_yw)
    np.testing.assert_array_equal(yg.numpy(), want_yg)


def test_cost_and_huber_weights_match_jax():
    """``_cost`` with and without the Huber loss and the IRLS weights, on
    residuals up to 40 px.  Tolerance: relative 1e-12 (float64)."""
    jp, pp = both("float64", mask_every=5)
    for huber in (None, 2.0):
        got = float(PB._cost(pp, pp.cams, pp.points, huber))
        with jax.enable_x64(True):
            want = float(JB._cost(jp, jp.cams, jp.points, huber))
        assert got == pytest.approx(want, rel=1e-12)
    r = np.random.default_rng(1).normal(0, 15, (300, 2))
    got = PB._huber_sqrt_weights(torch.from_numpy(r), 3.0).numpy()
    with jax.enable_x64(True):
        want = np.asarray(JB._huber_sqrt_weights(jnp.asarray(r), 3.0))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_jacobians_behind_the_camera_match_jax():
    """Points behind camera 0 (depth on ``project_points``'s 1e-9 floor,
    where the depth's derivative is 0) and cameras at rotation angles up
    to 2 rad: the written-out Jacobians against JAX's ``jacfwd``.
    Tolerance: 1e-9 relative to each array's largest entry (float64)."""
    a, _ = problem_arrays()
    a["points"][:5, 2] = -3.0
    a["cams"][2:, :3] = np.random.default_rng(4).normal(0, 1.0, (3, 3))
    with jax.enable_x64(True):
        jp = JB.BAProblem(**{k: jnp.asarray(v) for k, v in a.items()})
        want = [np.asarray(x) for x in JB._jacobians(jp, jp.cams, jp.points)]
    pp = PB.ba_problem_from_numpy(a, "cpu")
    got = [x.numpy() for x in PB._jacobians(pp, pp.cams, pp.points)]
    behind = np.isin(a["obs_pt"], np.arange(5)) & (a["obs_cam"] == 0)
    assert behind.any()
    assert np.all(got[1][behind][:, :, 5] == 0) and np.all(got[2][behind][:, :, 2] == 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9 * np.abs(w).max())
