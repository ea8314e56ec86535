"""The port's compositing stack (``sift_tpu_torch/models/blend.py``) against
the JAX package's ``models/blend.py``, on the CPU: global offsets, gain
compensation, the overlap metric, the pyramid's blur / down / up steps and
the seam-aware multiband blend.  Inputs are seeded numpy.  Each test states
its tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu.models.blend as JB
import sift_tpu.models.stitch as JS
import sift_tpu_torch.models.blend as PB
import sift_tpu_torch.models.stitch as PS

DTYPES = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}


def _scene(seed=0, shape=(48, 64)):
    """Three overlapping views of one smooth texture with different
    exposures, and their image -> canvas homographies."""
    rng = np.random.default_rng(seed)
    h, w = shape
    tex = rng.uniform(0, 255, (h + 8, 2 * w + 8, 3))
    for _ in range(3):  # smooth it, so a misregistration costs little
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1) + np.roll(tex, 1, (0, 1))) / 4
    shifts = [0, 30, 58]
    gains = [1.0, 1.25, 0.85]
    imgs = [np.clip(tex[4:4 + h, 4 + s:4 + s + w] * g, 0, 255).astype(np.float32)
            for s, g in zip(shifts, gains)]
    hs = [np.array([[1.0, 0, s], [0, 1, 0], [0, 0, 1]]) for s in shifts]
    hs[2][1, 0] = 0.004  # a slight shear: not a pure translation
    return imgs, hs


def test_solve_global_offsets_matches_jax():
    """Redundant edges with weights.  Tolerance: none (the same numpy)."""
    rng = np.random.default_rng(1)
    edges = [(0, 1), (1, 2), (0, 2), (2, 3), (1, 3)]
    ts = [rng.normal(0, 50, 2) for _ in edges]
    w = list(rng.uniform(5, 80, len(edges)))
    for weights in (None, w):
        np.testing.assert_array_equal(
            PB.solve_global_offsets(4, 1, edges, ts, weights),
            JB.solve_global_offsets(4, 1, edges, ts, weights))
    assert PB.solve_global_offsets(3, 0, [], []).shape == (3, 2)


def test_estimate_gains_matches_jax():
    """Tolerance: 1e-5 (the overlap means come from float32 warps)."""
    imgs, hs = _scene()
    oh, ow, t = PS._canvas_layout(imgs, hs)
    canvas = [t @ h for h in hs]
    got = PB.estimate_gains(imgs, canvas, oh, ow, device="cpu")
    want = JB.estimate_gains(imgs, canvas, oh, ow)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[1] < 1.0 < got[2]  # the bright view darkened, the dark one lifted
    # No usable overlap: all ones in both.
    far = [hs[0], np.array([[1.0, 0, 500], [0, 1, 0], [0, 0, 1]])]
    oh, ow, t = PS._canvas_layout(imgs[:2], far)
    args = (imgs[:2], [t @ h for h in far], oh, ow)
    np.testing.assert_array_equal(PB.estimate_gains(*args, device="cpu"), JB.estimate_gains(*args))


def test_overlap_consistency_matches_jax():
    """Aligned and misaligned layouts.  Tolerance: 1e-4 grey levels."""
    imgs, hs = _scene()
    bad = [h.copy() for h in hs]
    bad[1][0, 2] += 3.0
    for layout in (hs, bad):
        oh, ow, t = PS._canvas_layout(imgs, layout)
        args = (imgs, [t @ h for h in layout], oh, ow)
        got = PB.overlap_consistency(*args, device="cpu")
        assert abs(got - JB.overlap_consistency(*args)) < 1e-4
    assert got > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(13, 17), (16, 24, 3), (9, 30, 1)])
def test_blur5_and_down_match_jax(shape, dtype):
    """Zero padding renormalized by the blurred ones, odd and even shapes,
    with and without channels.  Tolerance: 1e-12 (float64) / 1e-4 grey
    levels (float32)."""
    npt, _ = DTYPES[dtype]
    x = np.random.default_rng(2).uniform(0, 255, shape).astype(npt)
    tol = 1e-12 if dtype == "float64" else 1e-4
    got = PB._blur5(torch.from_numpy(x)).numpy()
    want = np.asarray(JB._blur5(jnp.asarray(x)))
    assert got.shape == want.shape == shape and got.dtype == npt
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    got = PB._down(torch.from_numpy(x)).numpy()
    want = np.asarray(JB._down(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # A constant stays constant, at the borders too.
    np.testing.assert_allclose(PB._blur5(torch.full(shape, 7.0, dtype=torch.float64)).numpy(), 7.0,
                               rtol=1e-15)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(5, 7), (6, 8, 3), (1, 4)])
def test_up_matches_jax_image_resize(shape, dtype):
    """The exact 2x upsampling of the pyramid: ``F.interpolate`` against
    ``jax.image.resize(.., "bilinear")``, every row and column, the borders
    included.  Tolerance: 1e-12 (float64) / 1e-4 grey levels (float32)."""
    npt, _ = DTYPES[dtype]
    x = np.random.default_rng(3).uniform(0, 255, shape).astype(npt)
    th, tw = 2 * shape[0], 2 * shape[1]
    got = PB._up(torch.from_numpy(x), th, tw).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (th, tw) + shape[2:], method="bilinear"))
    assert got.shape == want.shape == (th, tw) + shape[2:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 if dtype == "float64" else 1e-4)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12 if dtype == "float64" else 1e-4)


@pytest.mark.parametrize("with_gains", [False, True])
def test_multiband_blend_matches_jax(with_gains):
    """Three same-shape views, 5 bands (the canvas padded to a multiple of
    16).  Tolerance: 0.01 grey levels on every pixel."""
    imgs, hs = _scene()
    oh, ow, t = PS._canvas_layout(imgs, hs)
    gains = JB.estimate_gains(imgs, [t @ h for h in hs], oh, ow) if with_gains else None
    got = PB.multiband_blend(imgs, hs, gains=gains, device="cpu")
    want = JB.multiband_blend(imgs, hs, gains=gains)
    assert got.shape == want.shape == (oh, ow, 3) and oh % 16 and ow % 16
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01)
    assert (want > 0).mean() > 0.8


def test_composite_and_fallbacks_match_jax():
    """``composite`` (gains + multiband), its feather fallbacks (a canvas
    over ``max_multiband_pixels``; mixed shapes) and ``seam_aware=False``.
    Tolerance: 0.01 grey levels."""
    imgs, hs = _scene()
    for kw in ({}, dict(max_multiband_pixels=100), dict(seam_aware=False)):
        got = PS.composite(imgs, hs, device="cpu", **kw)
        want = JS.composite(imgs, hs, **kw)
        np.testing.assert_allclose(got, want, rtol=0, atol=0.01)
    mixed = [imgs[0], imgs[1][:40], imgs[2]]
    np.testing.assert_allclose(PS.composite(mixed, hs, device="cpu"), JS.composite(mixed, hs),
                               rtol=0, atol=0.01)
