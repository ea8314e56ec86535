"""The port's matcher (plain version of kernel B + the ratio test) against
the JAX package's XLA matcher and its Pallas top-2 kernel in interpret mode.
Tolerance: none -- distances, indices and accept masks are integers."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.models.match import match_descriptors as jax_match
from sift_tpu.ops.pallas_match import pallas_top2
from sift_tpu_torch import kernels, match_descriptors
from sift_tpu_torch.ops.top2 import HUGE_D2, top2_plain

torch.set_num_threads(2)


def _case(kind):
    rng = np.random.default_rng(3)
    n, m = 300, 700
    d1 = rng.integers(0, 256, (n, 128), dtype=np.uint8)
    d2 = rng.integers(0, 256, (m, 128), dtype=np.uint8)
    d2[5] = d1[7]
    d2[600] = d1[7]  # duplicate best in a later block: first index wins
    d2[40] = d2[41]
    v1 = np.ones(n, bool)
    v1[::17] = False
    v2 = np.ones(m, bool)
    v2[100:120] = False
    if kind == "lone":
        v2[:] = False
        v2[333] = True  # one valid target: always accepts
    elif kind == "empty":
        v2[:] = False  # no valid target: never accepts
    return d1, v1, d2, v2


@pytest.mark.parametrize("kind", ["mixed", "lone", "empty"])
def test_match_equals_jax(kind):
    d1, v1, d2, v2 = _case(kind)
    want = [np.asarray(a) for a in jax_match(*(jnp.asarray(a) for a in (d1, v1, d2, v2)))]
    got = [a.numpy() for a in match_descriptors(d1, v1, d2, v2, device="cpu")]
    for name, g, w in zip(("idx", "accept", "best", "second"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    if kind == "lone":
        assert got[1].sum() == v1.sum()
    if kind == "empty":
        assert got[1].sum() == 0 and (got[2] == HUGE_D2).all()


@pytest.mark.parametrize("kind", ["mixed", "lone", "empty"])
def test_top2_equals_pallas_interpret(kind):
    d1, v1, d2, v2 = _case(kind)
    want = [np.asarray(a) for a in pallas_top2(
        jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2),
        interpret=True)]
    got = [a[0].numpy() for a in top2_plain(
        torch.from_numpy(d1)[None], torch.from_numpy(d2)[None], torch.from_numpy(v2)[None])]
    for name, g, w in zip(("best", "second", "idx"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_batched_pairs_equal_single_pairs():
    """(P, N, 128) matches P single-pair calls; the wrapper takes the plain
    version on CPU tensors and counts no launch."""
    cases = [_case(k) for k in ("mixed", "lone")]
    stack = [np.stack([c[i] for c in cases]) for i in range(4)]
    before = kernels.launch_counts()["top2"]
    batched = match_descriptors(*stack, device="cpu")
    assert kernels.launch_counts()["top2"] == before
    for p, c in enumerate(cases):
        single = match_descriptors(*c, device="cpu")
        for b, s in zip(batched, single):
            assert torch.equal(b[p], s)
