"""The port's separable blur (the plain version of kernel D) against the
JAX package: ``ops/pallas_blur.pallas_separable_blur`` in interpret mode
and ``ops/blur.separable_blur``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.config import gaussian_half_kernel
from sift_tpu.ops.blur import separable_blur as jax_blur
from sift_tpu.ops.pallas_blur import pallas_separable_blur
from sift_tpu_torch import kernels
from sift_tpu_torch.ops.blur import separable_blur
from sift_tpu_torch.ops.blur_pass import separable_blur_kernel

torch.set_num_threads(2)


def _img(shape, dtype, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(dtype)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("shape", [(64, 96), (47, 130)])
@pytest.mark.parametrize("sigma", [1.2, 3.09002])
def test_blur_matches_pallas_interpret(shape, sigma, batched):
    """Tolerance: rtol 2e-6, atol 2e-4 in float32, the Pallas kernel's own
    contract (tests/test_pallas_blur.py): same order and true division,
    XLA's elementwise chain may contract differently."""
    img = _img(((3,) if batched else ()) + shape, np.float32)
    k = gaussian_half_kernel(sigma)
    want = np.asarray(pallas_separable_blur(jnp.asarray(img), k, interpret=True))
    got = separable_blur(torch.from_numpy(img), k).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-4)


@pytest.mark.parametrize("sigma", [1.2, 3.09002])
def test_blur_bit_equal_to_jax_float64(sigma):
    """Tolerance: none (float64 bits)."""
    img = _img((2, 47, 130), np.float64, seed=1)
    k = gaussian_half_kernel(sigma)
    want = np.asarray(jax_blur(jnp.asarray(img), k))
    np.testing.assert_array_equal(separable_blur(torch.from_numpy(img), k).numpy(), want)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor kernel D's wrapper is the plain blur, bit for bit,
    and counts no launch; it refuses what the kernel cannot take."""
    img = torch.from_numpy(_img((2, 40, 72), np.float32, seed=2))
    k = gaussian_half_kernel(1.6)
    before = kernels.launch_counts()["blur_pass"]
    assert torch.equal(separable_blur_kernel(img, k), separable_blur(img, k))
    assert kernels.launch_counts()["blur_pass"] == before
    with pytest.raises(ValueError, match="unsupported device"):
        separable_blur_kernel(img.to("meta"), k)
