"""The port's octave front (plain version of kernel A) against the JAX
package: ``models/detect.octave_front_xla`` and the Pallas front kernel
``ops/pallas_pyramid.fused_octave_front`` in interpret mode."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu import SiftConfig
from sift_tpu.config import gaussian_half_kernel
from sift_tpu.models.detect import octave_front_xla
from sift_tpu.ops.blur import gaussian_blur
from sift_tpu.ops.pallas_pyramid import fused_octave_front
from sift_tpu_torch import kernels
from sift_tpu_torch.ops.octave_front import octave_front, octave_front_plain

torch.set_num_threads(2)

CFG = SiftConfig()
HKS = [gaussian_half_kernel(s) for s in CFG.gaussian_kernels()[1:]]
THR = CFG.extremum_threshold()
# (64, 96): one strip; (300, 160): several strips and W % 128 != 0;
# (7, 10): the last octave of a 640x480 frame, smaller than the halo.
SHAPES = [(64, 96), (300, 160), (7, 10)]
_xla_front = jax.jit(lambda x: octave_front_xla(x, HKS, THR))


def _seed(hw, dtype):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    base = rng.uniform(0, 255, (2,) + hw).astype(dtype)
    # Smoothed so that DoG extrema exist and are not razor-marginal.
    return np.array(gaussian_blur(jnp.asarray(base), 2.0 if hw[0] > 8 else 0.6))


@pytest.mark.parametrize("hw", SHAPES)
def test_front_equals_octave_front_xla_float64(hw):
    """Tolerance: none.  gauss/DoG bit-equal, mask/counts exact.  (float64
    only: in float32, XLA rewrites the division by sum_w into a reciprocal
    multiply, which the port and kernel A do not.)"""
    img = _seed(hw, np.float64)
    want = [np.asarray(a) for a in _xla_front(jnp.asarray(img))]
    got = [a.numpy() for a in octave_front_plain(torch.from_numpy(img), HKS, THR)]
    for name, g, w in zip(("gauss", "dog", "mask", "counts"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if hw[0] > 8:
        assert got[2].sum() > 0, "test image produced no extrema"


@pytest.mark.parametrize("hw", SHAPES)
def test_front_matches_pallas_interpret(hw):
    """Tolerance: atol 1e-4 on gauss/DoG in float32 (the Pallas kernel's own
    contract, tests/test_pallas_pyramid.py); mask and counts exact."""
    img = _seed(hw, np.float32)
    g, d, m, c = (np.asarray(a) for a in fused_octave_front(
        jnp.asarray(img), HKS, THR, interpret=True))
    tg, td, tm, tc = (a.numpy() for a in octave_front(torch.from_numpy(img), HKS, THR))
    np.testing.assert_allclose(tg, g, rtol=0, atol=1e-4)
    np.testing.assert_allclose(td, d, rtol=0, atol=1e-4)
    w = hw[1]
    m = np.pad(m, ((0, 0), (0, 0), (0, 0), (0, tm.shape[-1] - w)))
    np.testing.assert_array_equal(tm, m)
    np.testing.assert_array_equal(tc, c)


def test_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor the kernel wrapper runs the plain version and counts
    no launch."""
    img = torch.from_numpy(_seed((64, 96), np.float32))
    before = kernels.launch_counts()["octave_front"]
    for a, b in zip(octave_front(img, HKS, THR), octave_front_plain(img, HKS, THR)):
        assert torch.equal(a, b)
    assert kernels.launch_counts()["octave_front"] == before
