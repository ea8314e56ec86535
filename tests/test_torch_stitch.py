"""The port's homography estimation, warp and feather blend
(``sift_tpu_torch/models/stitch.py``, ``models/geometry.min_eigvec``)
against the JAX package's ``models/stitch.py``, on the CPU.

The two packages cannot share a random stream, so RANSAC is held in two
parts: the port's sampler (``sample_hypotheses``: a CPU generator, the same
indices on any device) on its own, and the deterministic rest
(``ransac_with_samples``) fed the JAX package's own sample indices.
Inputs are seeded numpy.  Each test states its tolerance.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu.models.geometry as jax_geometry
import sift_tpu.models.stitch as JS
import sift_tpu_torch.models.stitch as PS
from sift_tpu_torch.models.geometry import min_eigvec

DTYPES = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}


@partial(jax.jit, static_argnums=(1,))
def jax_samples(valid, num_hypotheses, seed=0):
    """The (K, 4) indices the JAX package's ``ransac_homography`` draws
    (``sift_tpu/models/stitch.py:136-140``), from the same program."""
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return jax.random.choice(jax.random.PRNGKey(seed), valid.shape[0],
                             shape=(num_hypotheses, 4), replace=True, p=probs)


def _true_h():
    h = np.eye(3)
    h[0, 0], h[1, 1], h[0, 1], h[1, 0] = 1.1, 0.93, 0.08, -0.05
    h[0, 2], h[1, 2], h[2, 0], h[2, 1] = 25.0, -13.0, 1e-4, -8e-5
    return h


def _project(h, p):
    ph = np.concatenate([p, np.ones((len(p), 1))], axis=1) @ np.asarray(h, np.float64).T
    return ph[:, :2] / ph[:, 2:3]


def _corners(h, w=640, hh=480):
    return _project(h, np.array([[0, 0], [w - 1, 0], [0, hh - 1], [w - 1, hh - 1]], float))


def _correspondences(seed=0, n=512, n_out=180, n_invalid=40, noise=0.3):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(0, 500, (n, 2))
    p2 = _project(_true_h(), p1) + rng.normal(0, noise, (n, 2))
    p2[:n_out] = rng.uniform(0, 500, (n_out, 2))
    valid = np.ones(n, bool)
    valid[n - n_invalid:] = False
    return p1, p2, valid


def test_dlt_matrix_matches_jax():
    """Tolerance: none (the same elementwise products)."""
    rng = np.random.default_rng(1)
    p1, p2 = rng.uniform(-2, 2, (2, 3, 7, 2))
    got = PS._dlt_matrix(torch.from_numpy(p1), torch.from_numpy(p2)).numpy()
    want = np.asarray(JS._dlt_matrix(jnp.asarray(p1), jnp.asarray(p2)))
    assert got.shape == (3, 14, 9)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_h_matches_jax(dtype):
    """Canvas-sized coordinates (up to 8192).  Tolerance: 1e-9 px in
    float64, 2e-3 px in float32 (a few ulps of 8192: the port rounds each
    product and sum, XLA's dot may contract)."""
    npt, _ = DTYPES[dtype]
    rng = np.random.default_rng(2)
    h = np.stack([_true_h(), np.linalg.inv(_true_h())]).astype(npt)
    pts = rng.uniform(0, 8192, (2, 300, 2)).astype(npt)
    got = PS._apply_h(torch.from_numpy(h), torch.from_numpy(pts)).numpy()
    want = np.asarray(JS._apply_h(jnp.asarray(h), jnp.asarray(pts)))
    assert got.dtype == npt
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 if dtype == "float64" else 2e-3)


def test_min_eigvec_matches_jax_up_to_sign():
    """Batched (5, 40, 9) systems.  Tolerance: 1e-10 after fixing each
    vector's sign by its largest entry (eigh's sign is arbitrary)."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5, 40, 9))
    got = min_eigvec(torch.from_numpy(a)).numpy()
    want = np.asarray(jax_geometry._min_eigvec(jnp.asarray(a)))

    def signed(v):
        k = np.abs(v).argmax(-1)
        return v * np.sign(np.take_along_axis(v, k[:, None], -1))

    np.testing.assert_allclose(signed(got), signed(want), rtol=0, atol=1e-10)
    assert np.allclose(np.linalg.norm(got, axis=-1), 1.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_solve_h_4pt_matches_jax(dtype):
    """Exact 4-point solves of non-degenerate samples.  Tolerance: 1e-8
    (float64) / 2e-3 (float32) relative to each homography's largest entry."""
    npt, _ = DTYPES[dtype]
    rng = np.random.default_rng(4)
    p1 = rng.uniform(-1.5, 1.5, (64, 4, 2)).astype(npt)
    p2 = (p1 * 1.05 + 0.1 + rng.normal(0, 0.05, p1.shape)).astype(npt)
    got = PS._solve_h_4pt(torch.from_numpy(p1), torch.from_numpy(p2)).numpy()
    want = np.asarray(JS._solve_h_4pt(jnp.asarray(p1), jnp.asarray(p2)))
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    tol = 1e-8 if dtype == "float64" else 2e-3
    assert np.all(np.abs(got - want) <= tol * scale)
    assert np.all(got[:, 2, 2] == 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_repeated_point_sample_does_not_raise_and_never_wins(dtype):
    """A sample that repeats a point is singular.  The port returns a
    hypothesis without raising (``solve_ex``): non-finite where the LU
    meets an exact zero pivot (float32 here), finite garbage where the
    1e-12 ridge keeps the pivot off zero (float64 here; JAX's LU gives
    finite garbage in both).  A non-finite hypothesis scores zero inliers
    (``nan < thr`` is false); among seven such samples and one good one,
    the good one wins.  Tolerance: none (counts); corners 1e-6 px
    (float64) / 0.05 px (float32)."""
    npt, _ = DTYPES[dtype]
    p1, p2, valid = _correspondences(seed=5, n_out=0, n_invalid=0, noise=0.0)
    s1 = p1[[3, 3, 7, 9]][None].astype(npt)
    s2 = p2[[3, 3, 7, 9]][None].astype(npt)
    got = PS._solve_h_4pt(torch.from_numpy(s1), torch.from_numpy(s2))
    want = np.asarray(JS._solve_h_4pt(jnp.asarray(s1), jnp.asarray(s2)))
    assert np.isfinite(want).all()
    assert np.isfinite(got.numpy()).all() == (dtype == "float64")
    if dtype == "float32":
        with np.errstate(invalid="ignore"):
            err2 = ((_project(got.numpy()[0], p1) - p2) ** 2).sum(-1)
        assert int((err2 < 9.0).sum()) == 0
    idx = torch.tensor([[3, 3, 7, 9]] * 7 + [[11, 140, 260, 400]])
    t1, t2 = (torch.from_numpy(a.astype(npt)) for a in (p1, p2))
    h, mask, count = PS.ransac_with_samples(t1, t2, torch.from_numpy(valid), idx)
    assert int(count) == int(mask.sum()) == len(p1)
    np.testing.assert_allclose(_corners(h.numpy()), _corners(_true_h()), rtol=0,
                               atol=1e-6 if dtype == "float64" else 0.05)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ransac_fed_jax_samples_matches_jax(dtype):
    """512 correspondences, 180 outliers, 40 invalid lanes, 1024
    hypotheses: the port's ``ransac_with_samples`` on JAX's own indices.
    Tolerance: identical inlier masks and counts; the corners of a 640 x 480
    frame within 1e-6 px (float64) / 0.05 px (float32)."""
    npt, _ = DTYPES[dtype]
    p1, p2, valid = _correspondences()
    j1, j2, jv = jnp.asarray(p1, npt), jnp.asarray(p2, npt), jnp.asarray(valid)
    h_j, mask_j, n_j = JS.ransac_homography(j1, j2, jv, 1024)
    idx = torch.from_numpy(np.asarray(jax_samples(jv, 1024)).astype(np.int64))
    h_p, mask_p, n_p = PS.ransac_with_samples(
        torch.from_numpy(p1.astype(npt)), torch.from_numpy(p2.astype(npt)),
        torch.from_numpy(valid), idx)
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))
    assert int(n_p) == int(n_j) >= 280
    tol = 1e-6 if dtype == "float64" else 0.05
    np.testing.assert_allclose(_corners(h_p.numpy()), _corners(np.asarray(h_j)), rtol=0, atol=tol)
    # Inside the points' 500 x 500 extent the estimate is the true map up
    # to the best 4-point sample's error (the refit's weights are misaligned
    # in both packages and it loses: ROADMAP.md, queue 3).
    np.testing.assert_allclose(_corners(h_p.numpy(), 500, 500), _corners(_true_h(), 500, 500),
                               rtol=0, atol=2.5)


def _two_groups():
    """Two disjoint groups of 20 correspondences, each exact under its own
    homography: every hypothesis drawn inside a group scores 20."""
    rng = np.random.default_rng(6)
    pa, pb = rng.uniform(0, 400, (2, 20, 2))
    h_b = np.array([[1.0, 0.0, -40.0], [0.0, 1.0, 25.0], [0.0, 0.0, 1.0]])
    p1 = np.concatenate([pa, pb])
    p2 = np.concatenate([_project(_true_h(), pa), _project(h_b, pb)])
    return p1, p2, np.ones(40, bool), h_b


@pytest.mark.parametrize("first", ["a", "b"])
def test_argmax_tie_takes_the_first_hypothesis(first):
    """Two hypotheses with equal inlier counts: both packages keep the
    first (``jnp.argmax`` / ``torch.argmax``).  Tolerance: 1e-6 px."""
    p1, p2, valid, h_b = _two_groups()
    rows = [[0, 5, 11, 17], [20, 26, 31, 37]]
    if first == "b":
        rows = rows[::-1]
    idx = torch.tensor(rows)
    h_p, mask_p, n_p = PS.ransac_with_samples(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid), idx)
    assert int(n_p) == 20
    want_h = _true_h() if first == "a" else h_b
    np.testing.assert_allclose(_corners(h_p.numpy()), _corners(want_h), rtol=0, atol=1e-6)
    assert mask_p.numpy()[:20].all() == (first == "a")
    # The JAX package's scoring on the same two hypotheses keeps the same.
    h_j = JS._solve_h_4pt(jnp.asarray(p1[np.array(rows)]), jnp.asarray(p2[np.array(rows)]))
    proj = JS._apply_h(h_j, jnp.asarray(p1)[None])
    counts = np.asarray((jnp.sum((proj - jnp.asarray(p2)[None]) ** 2, -1) < 9.0).sum(1))
    assert counts.tolist() == [20, 20] and int(jnp.argmax(counts)) == 0


def test_sampler_is_reproducible_and_draws_valid_lanes():
    """The same seed gives the same indices, another seed others; every
    index is a valid lane; no valid lane gives the last lane.  Tolerance:
    none."""
    rng = np.random.default_rng(7)
    valid = torch.from_numpy(rng.random(300) < 0.4)
    a = PS.sample_hypotheses(valid, 2048, seed=3)
    b = PS.sample_hypotheses(valid, 2048, seed=3)
    c = PS.sample_hypotheses(valid, 2048, seed=4)
    assert a.shape == (2048, 4) and a.dtype == torch.int64
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(valid[a].all())
    # Every valid lane is reachable, and about uniformly so.
    hist = torch.bincount(a.reshape(-1), minlength=300)[valid]
    assert int(hist.min()) > 0
    none = PS.sample_hypotheses(torch.zeros(50, dtype=torch.bool), 16)
    assert bool((none == 49).all())


def test_sampler_and_tie_on_the_card():
    """The card's indices equal the CPU's for the same seed and mask, and
    the card keeps the first of two tied hypotheses.  Needs a CUDA card
    (``chip_smoke.py``'s ``stitch`` phase holds the same on the H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    valid = torch.from_numpy(rng.random(8192) < 0.05)
    cpu = PS.sample_hypotheses(valid, 2048, seed=0)
    card = PS.sample_hypotheses(valid.cuda(), 2048, seed=0)
    assert card.device.type == "cuda" and torch.equal(card.cpu(), cpu)
    p1, p2, v, _ = _two_groups()
    h, _, n = PS.ransac_with_samples(*(torch.from_numpy(a).cuda() for a in (p1, p2, v)),
                                     torch.tensor([[0, 5, 11, 17], [20, 26, 31, 37]]).cuda())
    assert int(n) == 20
    np.testing.assert_allclose(_corners(h.cpu().numpy()), _corners(_true_h()), atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_warp_accumulate_matches_jax(dtype):
    """A 37 x 53 RGB image through a projective map onto a 60 x 80 canvas.
    Tolerance: 1e-9 (float64) / 2e-3 grey levels and 1e-5 of weight
    (float32); the coverage masks are identical."""
    npt, _ = DTYPES[dtype]
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 255, (37, 53, 3)).astype(npt)
    h = np.array([[1.05, 0.04, -6.0], [-0.03, 0.97, -4.5], [2e-4, -1e-4, 1.0]])
    h_inv = np.linalg.inv(h).astype(npt)
    acc_p, w_p = PS.warp_accumulate(torch.from_numpy(img), torch.from_numpy(h_inv), 60, 80)
    acc_j, w_j = JS.warp_accumulate(jnp.asarray(img), jnp.asarray(h_inv), 60, 80)
    acc_j, w_j = np.asarray(acc_j), np.asarray(w_j)
    assert acc_p.shape == (60, 80, 3) and w_p.shape == (60, 80)
    np.testing.assert_array_equal(w_p.numpy() > 0, w_j > 0)
    assert 0.3 < (w_j > 0).mean() < 0.9
    f64 = dtype == "float64"
    np.testing.assert_allclose(acc_p.numpy(), acc_j, rtol=0, atol=1e-9 if f64 else 2e-3)
    np.testing.assert_allclose(w_p.numpy(), w_j, rtol=0, atol=1e-12 if f64 else 1e-5)


def test_canvas_layout_matches_jax():
    """Host numpy, including a degenerate homography whose corners go to
    infinity (clamped).  Tolerance: none."""
    imgs = [np.zeros((40, 60, 3)), np.zeros((30, 50, 3)), np.zeros((40, 60, 3))]
    hs = [np.eye(3), _true_h(), np.array([[1.0, 0, 0], [0, 1, 0], [0.05, 0, 0]])]
    for sub in (hs[:2], hs):
        got = PS._canvas_layout(imgs[: len(sub)], sub, max_canvas=4096)
        want = JS._canvas_layout(imgs[: len(sub)], sub, max_canvas=4096)
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("shapes", ["same", "mixed"])
def test_blend_warped_matches_jax(shapes):
    """Three images with gains, canvas streamed in 32-row strips (two or
    more strips): the same-shape stack (JAX's ``lax.scan`` path) and a
    mixed-shape list.  Tolerance: 2e-3 grey levels (float32 warps)."""
    rng = np.random.default_rng(9)
    dims = [(40, 56), (40, 56), (40, 56)] if shapes == "same" else [(40, 56), (36, 50), (44, 52)]
    imgs = [rng.uniform(0, 255, (*d, 3)).astype(np.float32) for d in dims]
    hs = [np.eye(3), np.array([[1, 0, 30.0], [0, 1, 4.0], [0, 0, 1]]),
          np.array([[0.98, 0.02, 55.0], [-0.02, 1.0, 9.0], [0, 0, 1]])]
    gains = np.array([1.0, 1.1, 0.9])
    got = PS.blend_warped(imgs, hs, strip_rows=32, gains=gains, device="cpu")
    want = JS.blend_warped(imgs, hs, strip_rows=32, gains=gains)
    assert got.shape == want.shape and got.shape[0] > 32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert (want > 0).mean() > 0.5
