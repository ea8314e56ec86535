"""Kernel D's row schedule (``ops/blur_pass.blur_rolling_plain``, the CPU
model of ``csrc/blur_pass.cu``) against the plain blur, bit for bit, at
shapes that stress the schedule; and once against the JAX package's
``pallas_separable_blur`` in interpret mode."""

from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.ops.pallas_blur import pallas_separable_blur
from sift_tpu_torch.config import gaussian_half_kernel
from sift_tpu_torch.ops import blur_pass
from sift_tpu_torch.ops.blur import separable_blur
from sift_tpu_torch.ops.blur_pass import BATCH_ROWS, TILE_W, blur_rolling_plain, strip_rows_for
from sift_tpu_torch.ops.color import to_grayscale
from sift_tpu_torch.ops.resize import upsample_bilinear

torch.set_num_threads(2)
DATA = pathlib.Path(__file__).parent / "data"
DTYPES = [torch.float32, torch.float64]
# Resident CTAs an SM that the launcher takes from the runtime for the
# radius instances of the chain (ntaps: CTAs), as chip_smoke.py's phase
# kernel_d_vs_plain reported them on an NVIDIA H100 80GB HBM3 (132 SMs):
# registers, not threads, set them.
H100_CTAS_PER_SM = {5: 6, 6: 5, 7: 5, 9: 6, 11: 6}


def taps(n):
    """n one-sided taps of a gaussian wide enough to give them all weight."""
    return (gaussian_half_kernel(0.3 + n / 3) + [1e-3] * 16)[:n]


def noise(shape, dtype, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 255, shape)).to(dtype)


# id: (shape, taps, strip rows or None for the launcher's rule, batch rows)
CASES = {
    "ntaps1_one_row_a_step": ((2, 40, 70), 1, None, 1),
    "ntaps5_bench_radius": ((1, 90, 300), 5, 32, BATCH_ROWS),
    "ntaps11_ragged_strip": ((2, 61, 130), 11, 24, BATCH_ROWS),
    "ntaps16_largest_radius": ((1, 75, 140), 16, 40, BATCH_ROWS),
    "h_below_ring_r15": ((1, 9, 40), 16, None, BATCH_ROWS),
    "w_below_tile": ((3, 50, 37), 7, 16, BATCH_ROWS),
    "7x10_r10": ((2, 7, 10), 11, None, BATCH_ROWS),
    "7x11_r10_batch_3": ((1, 7, 11), 11, 7, 3),
    "one_row": ((1, 1, 5), 5, None, BATCH_ROWS),
    "one_column": ((1, 33, 1), 6, None, BATCH_ROWS),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_rolling_blur_bit_equal_to_plain(case, dtype):
    """Tolerance: none."""
    shape, n, strip, batch = CASES[case]
    img = noise(shape, dtype)
    hk = taps(n)
    got = blur_rolling_plain(img, hk, strip, batch)
    assert got.dtype == dtype and torch.equal(got, separable_blur(img, hk))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_rolling_blur_on_the_demo_frame(dtype):
    """The demo frame's doubled grayscale (998 x 1510, neither even nor a
    multiple of 64 in either direction), cropped to a tile and a ragged
    one, in the launcher's strips for the demo batch; 5 taps (the
    initial blur) and 11 (the chain's widest).  Tolerance: none."""
    rgb = np.load(DATA / "oracle_demo1.npz")["input"]
    gray = upsample_bilinear(to_grayscale(torch.from_numpy(rgb).to(dtype)[None]), 2, 2)
    assert tuple(gray.shape) == (1, 998, 1510)
    img = gray[:, :, 1510 - TILE_W - 30:].contiguous()
    for n in (5, 11):
        strip = strip_rows_for(2, 998, 1510, n - 1, H100_CTAS_PER_SM[n])
        got = blur_rolling_plain(img, taps(n), strip)
        assert torch.equal(got, separable_blur(img, taps(n))), n


def test_rolling_blur_matches_pallas_interpret():
    """Tolerance, tests/test_torch_blur.py's for float32 against the Pallas
    kernel: rtol 2e-6, atol 2e-4 (same order and true division; XLA's
    elementwise chain may contract differently)."""
    img = np.random.default_rng(1).uniform(0, 255, (2, 47, 130)).astype(np.float32)
    hk = gaussian_half_kernel(3.09002)
    want = np.asarray(pallas_separable_blur(jnp.asarray(img), hk, interpret=True))
    got = blur_rolling_plain(torch.from_numpy(img), hk, 16).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-4)


def test_ring_too_shallow_is_caught(monkeypatch):
    """Every ring read checks the row its slot holds: a ring one row
    shallower than 2r + batch fails instead of reading a stale row."""
    real = blur_pass._Ring

    def shallow(like, depth, width):
        return real(like, depth - 1, width)

    monkeypatch.setattr(blur_pass, "_Ring", shallow)
    with pytest.raises(AssertionError, match="ring slot"):
        blur_rolling_plain(noise((1, 60, 40), torch.float32), taps(5), 60)


def test_strip_rule_and_tap_cache():
    """The strip rule at the shapes kernel D meets (the numbers the CUDA
    launcher computed on an H100), and the wrapper's per-half-kernel tap
    cache."""
    ctas = H100_CTAS_PER_SM
    # The main path: 9 strips x 5 tiles x 16 images = 720 CTAs on 792 slots.
    assert strip_rows_for(16, 960, 1280, 4, ctas[5]) == 107
    # With 8 CTAs an SM the same rule takes 74-row strips: 1040 CTAs.
    assert strip_rows_for(16, 960, 1280, 4, 8) == 74
    assert strip_rows_for(16, 480, 640, 5, ctas[6]) == 37
    assert strip_rows_for(1, 960, 1280, 4, ctas[5]) == 32     # the staged path's frame
    assert strip_rows_for(2, 998, 1510, 4, ctas[5]) == 33     # the demo pair
    assert strip_rows_for(16, 7, 10, 10, ctas[11]) == 7
    hk = gaussian_half_kernel(1.6)
    a, sa = blur_pass._taps(tuple(hk))
    b, sb = blur_pass._taps(tuple(hk))
    assert a is b and sa == sb and a.dtype == np.float32 and len(a) == len(hk)
