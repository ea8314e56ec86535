"""The port's last public names against the JAX package: the dense
distance matrix ``pairwise_sq_dists``, the package exports, and
``gaussian_blur`` / ``full_kernel`` / ``compact_indices`` / ``xmul``."""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu.ops.blur as jax_blur
from sift_tpu.models.match import pairwise_sq_dists as jax_pairwise
from sift_tpu.utils.keypoints import compact_indices as jax_compact_indices
from sift_tpu_torch import pairwise_sq_dists
from sift_tpu_torch.ops.blur import full_kernel, gaussian_blur
from sift_tpu_torch.ops.top2 import top2_plain
from sift_tpu_torch.utils.keypoints import compact_indices
from sift_tpu_torch.utils.numerics import xmul
from test_match import descs  # noqa: F401  (the JAX matcher tests' fixture)


def _exact(d1, d2):
    a, b = d1.astype(np.int64), d2.astype(np.int64)
    return (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2 * a @ b.T


def _seeded():
    rng = np.random.default_rng(2024)
    d1 = rng.integers(0, 256, (300, 128), dtype=np.uint8)
    d2 = rng.integers(0, 256, (257, 128), dtype=np.uint8)
    d1[:4] = 255  # the largest norms
    d2[:3] = 0
    d2[100] = d1[7]
    return d1, d2


@pytest.mark.parametrize("case", ["test_match_fixture", "seeded_300x257"])
def test_pairwise_sq_dists_exact_and_equal_to_jax(case, descs):  # noqa: F811
    d1, d2 = descs if case == "test_match_fixture" else _seeded()
    got = pairwise_sq_dists(d1, d2, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(d1), len(d2))
    np.testing.assert_array_equal(got.numpy(), _exact(d1, d2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pairwise(jnp.asarray(d1),
                                                                       jnp.asarray(d2))))
    np.testing.assert_array_equal(pairwise_sq_dists(torch.from_numpy(d1), torch.from_numpy(d2),
                                                    device="cpu").numpy(), got.numpy())


def test_row_minimum_is_the_matchers_best():
    """Each row's minimum and first argmin are ``top2_plain``'s best and
    index (the plain version of kernel B)."""
    d1, d2 = _seeded()
    d = pairwise_sq_dists(d1, d2, device="cpu")
    best, _, idx = top2_plain(torch.from_numpy(d1)[None], torch.from_numpy(d2)[None],
                              torch.ones(1, len(d2), dtype=torch.bool))
    np.testing.assert_array_equal(d.min(1).values.numpy(), best[0].numpy())
    np.testing.assert_array_equal(np.argmin(d.numpy(), axis=1), idx[0].numpy())


@pytest.mark.parametrize("sub", ["", ".ops", ".models", ".utils"])
def test_every_jax_export_exists(sub):
    jax_mod = importlib.import_module(f"sift_tpu{sub}")
    port = importlib.import_module(f"sift_tpu_torch{sub}")
    missing = [n for n in jax_mod.__all__ if not hasattr(port, n)]
    assert not missing, f"sift_tpu_torch{sub} lacks {missing}"
    assert set(jax_mod.__all__) <= set(port.__all__)


@pytest.mark.parametrize("sigma", [1.6, 3.09002])
def test_gaussian_blur_bit_exact_float64(sigma):
    img = np.random.default_rng(3).uniform(0, 255, (2, 37, 53))
    got = gaussian_blur(torch.from_numpy(img), sigma).numpy()
    want = np.asarray(jax_blur.gaussian_blur(jnp.asarray(img), sigma))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("sigma", [0.8, 1.6, 3.09002])
def test_full_kernel_equal(sigma):
    from sift_tpu.config import gaussian_half_kernel

    hk = gaussian_half_kernel(sigma)
    got, want = full_kernel(hk), jax_blur.full_kernel(hk)
    assert got.dtype == np.float64 and got.shape == (2 * len(hk) - 1,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,cap", [(64, 32), (128, 128), (96, 160)])
def test_compact_indices_equal_to_jax(n, cap):
    """``tests/test_dedup_fast.py``'s three cases."""
    valid = np.random.default_rng(n + cap).random(n) < 0.6
    idx, in_range = compact_indices(torch.from_numpy(valid), cap)
    jidx, jin = jax_compact_indices(jnp.asarray(valid), cap)
    np.testing.assert_array_equal(in_range.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy()[in_range.numpy()], np.nonzero(valid)[0][:cap])


def test_xmul_is_the_product():
    a = torch.from_numpy(np.random.default_rng(1).normal(size=50))
    b = torch.from_numpy(np.random.default_rng(2).normal(size=50))
    assert torch.equal(xmul(a, b), a * b)
    assert xmul(3.0, 0.1) == 3.0 * 0.1
