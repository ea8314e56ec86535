"""Kernel B's scan (``ops/top2.top2_tiled_plain``, the CPU model of
``csrc/top2.cu``: column splits, 128-column tiles, 8-column fragments, two
columns a lane, the quad and split merges) against the plain matcher, bit
for bit, with ties planted where the scan could get them wrong; and once
against the JAX package's ``pallas_top2`` in interpret mode.  Tolerance:
none -- distances and indices are integers."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.ops.pallas_match import pallas_top2
from sift_tpu_torch import kernels
from sift_tpu_torch.ops.top2 import HUGE_D2, split_for, top2, top2_plain, top2_tiled_plain

torch.set_num_threads(2)


def descs(p, n, m, seed=0):
    rng = np.random.default_rng(seed)
    d1 = torch.from_numpy(rng.integers(0, 256, (p, n, 128), dtype=np.uint8))
    d2 = torch.from_numpy(rng.integers(0, 256, (p, m, 128), dtype=np.uint8))
    return d1, d2, torch.ones((p, m), dtype=torch.bool)


def tie(d1, d2, row, cols):
    """Targets ``cols`` equal to query ``row``: a tie at distance 0."""
    for c in cols:
        d2[:, c] = d1[:, row]


def case_fragment():
    """Two columns of one lane (2, 3) and of two lanes (1, 6) of a fragment."""
    d1, d2, v2 = descs(1, 40, 200)
    tie(d1, d2, 7, [2, 3])
    tie(d1, d2, 8, [1, 6])
    return d1, d2, v2, None


def case_warps():
    """Rows 7 and 30 (warps 0 and 1) and 50 (warp 3) with the same tie."""
    d1, d2, v2 = descs(2, 64, 300, seed=1)
    d1[:, 30] = d1[:, 7]
    d1[:, 50] = d1[:, 7]
    tie(d1, d2, 7, [9, 250])
    return d1, d2, v2, None


def case_tiles():
    """A tie across 128-column tiles (5, 130, 260), one split."""
    d1, d2, v2 = descs(1, 20, 300, seed=2)
    tie(d1, d2, 3, [5, 130, 260])
    return d1, d2, v2, (1, 3)


def case_splits():
    """Ties across three splits of one tile each, and the best of a row
    only in the last split; invalid columns between."""
    d1, d2, v2 = descs(1, 70, 384, seed=3)
    tie(d1, d2, 0, [127, 128, 383])
    tie(d1, d2, 69, [300])
    v2[:, 200:210] = False
    return d1, d2, v2, (3, 1)


def case_ragged():
    """M a multiple of neither 8 nor 128, N below a CTA's 64 rows, the
    launcher's split rule; a duplicate of the best in the ragged tail."""
    d1, d2, v2 = descs(3, 10, 131, seed=4)
    tie(d1, d2, 9, [0, 130])
    return d1, d2, v2, None


def case_tiny():
    d1, d2, v2 = descs(2, 3, 5, seed=5)
    tie(d1, d2, 1, [3, 4])
    return d1, d2, v2, None


def case_invalid():
    """An all-invalid pair beside a pair with one valid target (at the end
    of a ragged tile) and invalid ties."""
    d1, d2, v2 = descs(2, 30, 150, seed=6)
    tie(d1, d2, 4, [10, 11])
    v2[0] = False
    v2[1] = False
    v2[1, 149] = True
    return d1, d2, v2, None


CASES = dict(fragment=case_fragment, warps=case_warps, tiles=case_tiles, splits=case_splits,
             ragged=case_ragged, tiny=case_tiny, invalid=case_invalid)


@pytest.mark.parametrize("case", CASES)
def test_tiled_scan_equals_plain(case):
    d1, d2, v2, splits = CASES[case]()
    got = top2_tiled_plain(d1, d2, v2, splits)
    for name, a, b in zip(("best", "second", "idx"), got, top2_plain(d1, d2, v2)):
        assert a.dtype == torch.int32 and torch.equal(a, b), name
    if case == "invalid":
        assert (got[0][0] == HUGE_D2).all() and (got[2][0] == 0).all()
        assert (got[2][1] == 149).all() and (got[1][1] == HUGE_D2).all()


def test_no_targets():
    """M = 0: (HUGE, HUGE, 0), what an all-invalid row gives."""
    d1, d2, v2 = descs(2, 17, 0)
    best, second, idx = top2_tiled_plain(d1, d2, v2)
    assert (best == HUGE_D2).all() and (second == HUGE_D2).all() and (idx == 0).all()
    assert best.shape == (2, 17)


def test_tiled_scan_equals_pallas_interpret():
    d1, d2, v2, _ = case_splits()
    v1 = np.ones(d1.shape[1], bool)
    want = pallas_top2(jnp.asarray(d1[0].numpy()), jnp.asarray(v1), jnp.asarray(d2[0].numpy()),
                       jnp.asarray(v2[0].numpy()), interpret=True)
    for name, a, b in zip(("best", "second", "idx"), top2_tiled_plain(d1, d2, v2, (3, 1)), want):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b), err_msg=name)


def test_split_rule():
    """The launcher's split rule at the shapes kernel B meets: the main path's
    8 pairs of 2048 (256 CTAs of rows, two splits of 8 tiles), the demo
    pair's 1286 x 1430 (21 CTAs of rows, six splits of 2 tiles), and its
    edges; the wrapper takes the plain version on CPU tensors."""
    assert split_for(8, 2048, 2048) == (2, 8)
    assert split_for(1, 1286, 1430) == (6, 2)
    assert split_for(1, 10, 0) == (1, 0)
    assert split_for(1, 10, 5) == (1, 1)
    assert split_for(1, 64, 128 * 20) == (7, 3)
    d1, d2, v2, _ = case_ragged()
    before = kernels.launch_counts()["top2"]
    assert all(torch.equal(a, b) for a, b in zip(top2(d1, d2, v2), top2_plain(d1, d2, v2)))
    assert kernels.launch_counts()["top2"] == before
