"""The port's cylindrical panorama driver (``sift_tpu_torch/models/
cylindrical.py``) against the JAX package's ``models/cylindrical.py``, on
the CPU: focal estimation, the cylindrical warp, the robust per-edge
motions, the global rigid solve, and the whole driver on three crops of
the CAVE-01 frame 05 (``tests/data/scene_oracle``) with the JAX test's own
bounds (``tests/test_cylindrical.py``).  Each test states its tolerance.
"""

from __future__ import annotations

import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu.models.cylindrical as JC
import sift_tpu_torch.models.cylindrical as PC
from sift_tpu_torch import SiftConfig
from sift_tpu_torch.models.blend import overlap_consistency
from sift_tpu_torch.models.stitch import _canvas_layout
from sift_tpu_torch.utils.stitch_graph import StitchGraph

DATA = pathlib.Path(__file__).parent / "data"


def _rotation_homography(f, cx, cy, angle):
    k = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    c, s = math.cos(angle), math.sin(angle)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    h = k @ r @ np.linalg.inv(k)
    return h / h[2, 2]


def test_focal_estimates_match_jax():
    """Rotation homographies, random ones and the fallback.  Tolerance:
    none (the same float64 host code)."""
    rng = np.random.default_rng(0)
    hs = [_rotation_homography(520.0, 320, 240, a) for a in (0.15, -0.2, 0.3)]
    hs += [np.eye(3) + rng.normal(0, 0.05, (3, 3)) for _ in range(20)]
    for h in hs:
        assert PC.focal_from_homography(h) == JC.focal_from_homography(h)
    assert PC.estimate_focal(hs[:3], 640) == JC.estimate_focal(hs[:3], 640)
    assert abs(PC.estimate_focal(hs[:3], 640) - 520.0) < 0.05 * 520.0
    assert PC.estimate_focal(hs, 640, 480) == JC.estimate_focal(hs, 640, 480)
    assert PC.estimate_focal([np.eye(3)], 640) == JC.estimate_focal([np.eye(3)], 640) == 544.0


@pytest.mark.parametrize("supersample", [1, 2])
@pytest.mark.parametrize("f,border", [(220.0, 0), (600.0, 7)])
def test_cylindrical_warp_matches_jax(f, border, supersample):
    """Float32 on a 40 x 64 RGB image.  The two libms' tan / cos differ in
    the last ulp, which can move a sample across a pixel or the image edge.
    Tolerance: masks equal on all but 0.5% of pixels; where both cover,
    0.01 grey levels (bilinear sampling is continuous across a pixel)."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (40, 64, 3)).astype(np.float32)
    got_v, got_m = PC.cylindrical_warp(torch.from_numpy(img), f, border, supersample)
    want_v, want_m = JC.cylindrical_warp(jnp.asarray(img), f, border, supersample)
    got_v, got_m = got_v.numpy(), got_m.numpy()
    want_v, want_m = np.asarray(want_v), np.asarray(want_m)
    assert got_v.shape == want_v.shape == (40, 64 + 2 * border, 3)
    assert (got_m != want_m).mean() <= 0.005
    both = (got_m > 0) & (want_m > 0)
    assert both.mean() > 0.5
    d = np.abs(got_v - want_v)[both]
    assert d.max() <= 0.01


def test_robust_translation_and_rigid_match_jax():
    """The same numpy host code and the same ``default_rng`` stream.
    Tolerance: none."""
    rng = np.random.default_rng(5)
    n = 200
    p1 = rng.uniform(0, 300, (n, 2))
    p2 = p1 @ JC._rot2(0.02).T + np.array([45.0, -7.0]) + rng.normal(0, 0.25, (n, 2))
    p2[:30] = rng.uniform(0, 300, (30, 2))
    ok = np.ones(n, bool)
    ok[-10:] = False
    t_p, n_p = PC.robust_translation(p1, p2, ok)
    t_j, n_j = JC.robust_translation(p1, p2, ok)
    np.testing.assert_array_equal(t_p, t_j)
    assert n_p == n_j
    a_p, tr_p, k_p = PC.robust_rigid(p1, p2, ok)
    a_j, tr_j, k_j = JC.robust_rigid(p1, p2, ok)
    assert (a_p, k_p) == (a_j, k_j) and k_p > 120
    np.testing.assert_array_equal(tr_p, tr_j)
    assert abs(a_p - 0.02) < 2e-3
    one = np.zeros(n, bool)
    one[0] = True
    assert PC.robust_rigid(p1, p2, one)[2] == JC.robust_rigid(p1, p2, one)[2]


def test_solve_global_rigid_matches_jax():
    """Three images around a center with known rigids.  Tolerance: none
    (same numpy), and 1e-9 / 1e-6 against the truth."""
    phis_true = np.array([0.015, 0.0, -0.02])
    offs_true = np.array([[100.0, 5.0], [0.0, 0.0], [-95.0, 3.0]])
    edges = [(0, 1), (1, 2)]
    alphas = [phis_true[i] - phis_true[j] for i, j in edges]
    ts = [PC._rot2(-phis_true[j]) @ (offs_true[i] - offs_true[j]) for i, j in edges]
    for w in (None, [30.0, 80.0]):
        got = PC.solve_global_rigid(3, 1, edges, alphas, ts, w)
        want = JC.solve_global_rigid(3, 1, edges, alphas, ts, w)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)
    np.testing.assert_allclose(got[0], phis_true, atol=1e-9)
    np.testing.assert_allclose(got[1], offs_true, atol=1e-6)


def test_stitch_scene_cylindrical_on_cave01_crops():
    """The JAX end-to-end test's case and bounds on the port, on the CPU:
    three crops of one real frame, focal 2000, capacities 1024 / 512 /
    2048.  Bounds: height >= 400, width >= 560, std > 10, overlap
    consistency < 6.0 grey levels."""
    tex = np.load(DATA / "scene_oracle" / "cave01_05.npz")["input"].astype(np.float32)
    crops = [tex[:, 0:360], tex[:, 140:500], tex[:, 280:640]]
    graph = StitchGraph(center_index=1, center_rotation=0.0, images_count=3,
                        edges=((0, 1), (1, 2)))
    cfg = SiftConfig(dtype=torch.float32, extrema_cap=1024, kp_cap=512, ori_cap=2048)
    diag: dict = {}
    pano = PC.stitch_scene_cylindrical(crops, graph, cfg, focal=2000.0, diagnostics=diag,
                                       device="cpu")
    assert pano.shape[0] >= 400 and pano.shape[1] >= 560, pano.shape
    assert pano.std() > 10
    assert np.isfinite(pano).all() and pano.min() >= 0 and pano.max() <= 255
    oh, ow, t = _canvas_layout(diag["warped"], diag["homographies"])
    ci = overlap_consistency(diag["warped"], [t @ h for h in diag["homographies"]], oh, ow,
                             device="cpu")
    assert ci < 6.0, f"overlap consistency degraded: {ci}"
    assert len(diag["edges"]) == 2 and diag["edge_residual_px"] < 1.0
