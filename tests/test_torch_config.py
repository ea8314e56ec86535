"""sift_tpu_torch.config is the JAX package's config, number for number."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift_tpu import config as jcfg
from sift_tpu_torch import config as tcfg

torch.set_num_threads(2)

VARIANTS = [
    dict(),
    dict(init_sigma=1.8, intervals=4, contrast_threshold=0.03),
    dict(intervals=2, double_image_size=False),
]


@pytest.mark.parametrize("kw", VARIANTS)
def test_derived_math_bit_equal(kw):
    """Tolerance: none -- every value equal as float64 bits."""
    j = jcfg.SiftConfig(**kw)
    t = tcfg.SiftConfig(**kw)
    assert t.gaussian_kernels() == j.gaussian_kernels()
    for s in j.gaussian_kernels():
        hj = jcfg.gaussian_half_kernel(s)
        ht = tcfg.gaussian_half_kernel(s)
        assert ht == hj
        assert tcfg.half_kernel_weight_sum(ht) == jcfg.half_kernel_weight_sum(hj)
    assert t.extremum_threshold() == j.extremum_threshold()
    for w, h in [(1280, 960), (640, 480), (192, 128), (96, 64), (10, 7)]:
        assert t.octaves_count(w, h) == j.octaves_count(w, h)


def test_constants_equal():
    for name in ("M_PI2", "MAX_CONVERGENCE_STEPS", "CONVERGENCE_THR",
                 "ORI_SMOOTH_ITERATIONS", "DESC_HIST_WIDTH", "DESC_HIST_BINS",
                 "DESC_MAGNITUDE_THR", "INT_DESCR_FCTR"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_from_reference_round_trip(dtype):
    j = jcfg.SiftConfig(
        dtype=getattr(jnp, dtype), extrema_cap=6144, kp_cap=1536,
        ori_cap=2048, init_sigma=1.7, refine_active_cap=512,
    )
    fields = dataclasses.asdict(j)
    fields["dtype"] = np.dtype(j.dtype).name
    t = tcfg.SiftConfig.from_reference(fields)
    assert t.dtype == getattr(torch, dtype)
    for f in dataclasses.fields(tcfg.SiftConfig):
        if f.name in fields and f.name != "dtype":
            assert getattr(t, f.name) == fields[f.name], f.name
    # Handing the dtype object itself works too.
    assert tcfg.SiftConfig.from_reference(dataclasses.asdict(j)) == t
    assert t.ori_cand_slots == 8  # models/sift.py ORI_CAND_SLOTS
