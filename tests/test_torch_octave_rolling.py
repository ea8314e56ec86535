"""The rolling row schedule of kernels A, C and F (``ops/octave_rolling.
octave_rolling_plain``, the CPU model of ``csrc/octave_front.cu``) against
the plain versions, bit for bit, at shapes that stress the schedule; and
once against the JAX package's ``fused_octave_blur`` in interpret mode."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.ops.pallas_pyramid import fused_octave_blur
from sift_tpu_torch import SiftConfig
from sift_tpu_torch.models.pyramid import blur_half_kernels
from sift_tpu_torch.ops.octave_blur import octave_blur_plain
from sift_tpu_torch.ops.octave_front import octave_front_plain
from sift_tpu_torch.ops.octave_rolling import (
    BATCH_ROWS,
    SMEM_LIMIT,
    batch_rows_for,
    layer_ext,
    octave_rolling_plain,
    ring_plan,
    row_ranges,
    strip_rows_for,
)

torch.set_num_threads(2)
HKS = blur_half_kernels(SiftConfig())  # radii 4, 5, 6, 8, 10
DTYPES = [torch.float32, torch.float64]


def blobs(shape, dtype):
    """Low noise under sparse bright points: blurred, they are the extrema
    the mask has to find."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 20, shape) + 255 * (rng.uniform(0, 1, shape) < 0.02)
    return torch.from_numpy(img).to(dtype)


# id: (shape, blur chain, strip rows, batch rows)
BLUR_CASES = {
    "7x10_below_smallest_ring": ((2, 7, 10), HKS, 32, 8),
    "1x5_one_row": ((1, 1, 5), HKS, 8, 8),
    "30x40_below_halo": ((2, 30, 40), HKS, 16, BATCH_ROWS),
    "30x40_strips_of_one_batch": ((30, 40), HKS[:4], 8, 8),
    "61x130_ragged_strip": ((1, 61, 130), HKS[1:4], 24, 8),
    "24x256_ragged_batch": ((1, 24, 256), HKS + HKS[:1], 7, 3),
    "20x129_eight_layers": ((1, 20, 129), HKS + HKS[:3], 16, 8),
}
FRONT_CASES = {
    "7x10_below_smallest_ring": ((2, 7, 10), HKS, 32, 8),
    "30x40_below_halo": ((2, 30, 40), HKS, 16, 8),
    "30x40_strips_of_one_batch": ((1, 30, 40), HKS[:4], 8, 8),
    "33x70_three_layers": ((2, 33, 70), HKS[:3], 12, 4),
    "61x130_ragged_strip": ((1, 61, 130), HKS, 24, BATCH_ROWS),
    "100x257_ragged_strip": ((1, 100, 257), HKS[:3], 40, BATCH_ROWS),
    "24x256_ragged_batch": ((1, 24, 256), HKS + HKS[:1], 7, 3),
    "20x129_eight_layers": ((1, 20, 129), HKS + HKS[:3], 16, 8),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", BLUR_CASES)
def test_rolling_blur_bit_equal_to_plain(case, dtype):
    """Kernel C's schedule (no mask, so no +1 halo).  Tolerance: none."""
    shape, hks, strip, batch = BLUR_CASES[case]
    seed = blobs(shape, dtype)
    got = octave_rolling_plain(seed, hks, strip, batch)
    for name, a, b in zip(("gauss", "dog"), got, octave_blur_plain(seed, hks)):
        assert a.dtype == dtype and torch.equal(a, b), name


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", FRONT_CASES)
def test_rolling_front_bit_equal_to_plain(case, dtype):
    """Kernels A and F's schedule: gauss, DoG, mask and counts.  Tolerance:
    none.  The mask must have found something for the comparison to count."""
    shape, hks, strip, batch = FRONT_CASES[case]
    seed = blobs(shape, dtype)
    got = octave_rolling_plain(seed, hks, strip, batch, threshold=0.02)
    ref = octave_front_plain(seed, hks, 0.02)
    for name, a, b in zip(("gauss", "dog", "mask", "counts"), got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    if len(hks) >= 5 and min(shape[-2:]) >= 20:
        assert int(ref[3].sum()) > 0


def test_rolling_blur_matches_pallas_interpret():
    """Tolerance, as tests/test_torch_octave_blur.py states for float32:
    gauss within atol 1e-4 of the Pallas kernel (its own contract), each DoG
    within 2e-4 (the sum of two gauss tolerances)."""
    img = np.random.default_rng(0).uniform(0, 255, (48, 160)).astype(np.float32)
    jg, jd = fused_octave_blur(jnp.asarray(img), HKS, interpret=True)
    g, d = octave_rolling_plain(torch.from_numpy(img), HKS, 24)
    np.testing.assert_array_equal(g[0].numpy(), img)
    for i in range(len(HKS)):
        np.testing.assert_allclose(g[i + 1].numpy(), np.asarray(jg[i]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(d[i].numpy(), np.asarray(jd[i]), rtol=0, atol=2e-4)


def test_ring_too_shallow_is_caught():
    """Every ring read checks the row its slot holds: with one row less
    than ``ring_plan`` gives, the model fails instead of reading stale rows
    (so the depths the CUDA launcher uses are the least that work)."""
    import sift_tpu_torch.ops.octave_rolling as R

    seed = blobs((1, 72, 40), torch.float32)
    full = R.ring_plan

    for ring in ("h", "g", "d"):
        def shallow(*a, ring=ring, **kw):
            plan = full(*a, **kw)
            plan[ring] = {k: (d - 1, p) for k, (d, p) in plan[ring].items()}
            return plan

        R.ring_plan = shallow
        try:
            with pytest.raises(AssertionError, match="ring slot"):
                octave_rolling_plain(seed, HKS, 72, 8, threshold=0.02)
        finally:
            R.ring_plan = full


def test_ring_plan_and_strip_rule():
    """The default chain's shared-memory sum and the strip rule at the
    bench's octave shapes, batch 16 and one frame: the numbers the CUDA
    launcher computes (csrc/octave_front.cu ``launch``, ``strip_rows_for``)."""
    radii = [len(hk) - 1 for hk in HKS]
    assert radii == [4, 5, 6, 8, 10]
    assert layer_ext(radii, True) == [34, 30, 25, 19, 11, 1]
    front, blur = ring_plan(radii, True), ring_plan(radii, False)
    assert [d for d, _ in front["h"].values()] == [20, 22, 24, 28, 32]
    assert [d for d, _ in front["g"].values()] == [16, 17, 18, 20, 22]
    assert [d for d, _ in front["d"].values()] == [25, 28, 32, 24, 14]
    assert (front["bytes"], blur["bytes"]) == (208664, 142952)
    assert front["bytes"] + 256 <= SMEM_LIMIT
    # Chains whose rings do not fit at 12 rows a step get a smaller batch.
    chains = {name: [len(hk) - 1 for hk in blur_half_kernels(SiftConfig(**kw))]
              for name, kw in dict(default={}, four=dict(intervals=4), five=dict(intervals=5),
                                   wide=dict(init_sigma=2.4, intervals=5)).items()}
    assert {k: batch_rows_for(v, True) for k, v in chains.items()} == dict(
        default=12, four=11, five=9, wide=5)
    assert batch_rows_for(chains["wide"], False) == 12 and batch_rows_for([15] * 8, True) == 0
    shapes = [(960, 1280), (480, 640), (240, 320), (120, 160), (60, 80), (30, 40), (15, 20), (7, 10)]
    assert [strip_rows_for(16, h, w, 34) for h, w in shapes] == [320, 160, 120, 40, 60, 30, 15, 7]
    assert [strip_rows_for(1, h, w, 33) for h, w in shapes][:3] == [74, 32, 35]
    assert row_ranges(64, 128, 100, [34, 1]) == [(30, 100), (63, 100)]
    assert BATCH_ROWS == 12
