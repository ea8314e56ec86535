"""The port's row-sharded ``spatial_detect_and_describe`` on four gloo ranks
against the single-device staged pipeline, under the JAX test's own
tolerances (tests/test_spatial.py): equal counts, a 1:1 assignment within
(2e-3, 2e-3, 2e-3, 1e-3) on (x, y, size, pori) in the same octave, and
descriptor bytes off by more than 2 in under 0.1%, off at all in under 5%.
CAVE 00 at a quarter of its size, every octave, float64 against the JAX
package's ``detect_stages`` (its Pallas paths off) and float32 against the
port's.  A slow case holds the port against the JAX function itself at an
eighth of the size and two octaves: the JAX side compiles for minutes on
the CPU."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sift_tpu import SiftConfig as JaxConfig
from sift_tpu.models.sift import detect_stages as jax_detect_stages
from sift_tpu.parallel.spatial import spatial_detect_and_describe as jax_spatial
from sift_tpu.parallel.spatial import spatial_halo as jax_spatial_halo
from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.models.sift import detect_stages
from sift_tpu_torch.parallel.multihost import MeshSpec, Step, run_steps
from sift_tpu_torch.parallel.spatial import spatial_detect_and_describe, spatial_halo

DATA = "tests/data"
RANKS = 4
CAPS = dict(extrema_cap=2048, kp_cap=1024, ori_cap=2048)
F64 = SiftConfig(dtype=torch.float64, **CAPS)
F32 = SiftConfig(**CAPS)


def quarter():
    return np.load(f"{DATA}/oracle_cave00.npz")["input"][::4, ::4].astype(np.float32)


def jax_config(cfg: SiftConfig, dtype) -> JaxConfig:
    names = {f.name for f in dataclasses.fields(JaxConfig)} - {"dtype"}
    return JaxConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names},
                     dtype=dtype, use_pallas_pyramid=False, use_pallas_blur=False)


@pytest.fixture(scope="module")
def ranks():
    """One spawn: the quarter frame in float64 and float32 over a flat
    data axis of 4 ranks (interior ranks, both border ranks and the
    octaves computed whole)."""
    img = quarter()
    steps = [Step(spatial_detect_and_describe, (img.astype(np.float64), F64, MeshSpec(4, 1))),
             Step(spatial_detect_and_describe, (img, F32, MeshSpec(4, 1)))]
    return run_steps(steps, RANKS, device="cpu")


def cols(kp):
    v = np.asarray(kp.valid)
    return (np.stack([np.asarray(a)[v].astype(np.float64) for a in (kp.x, kp.y, kp.size, kp.pori)],
                     axis=1),
            np.asarray(kp.octave)[v], np.asarray(kp.desc)[v])


def assert_same_keypoints(got, want, min_count):
    """tests/test_spatial.py's comparison."""
    a, oct_a, desc_a = cols(got)
    b, oct_b, desc_b = cols(want)
    assert len(b) > min_count
    assert len(a) == len(b), (len(a), len(b))
    tol = np.array([2e-3, 2e-3, 2e-3, 1e-3])
    close = (np.abs(a[None, :, :] - b[:, None, :]) <= tol).all(-1) & (
        oct_a[None, :] == oct_b[:, None])
    assert close.any(axis=1).sum() == len(b)
    assign = close.argmax(axis=1)
    assert len(set(assign.tolist())) == len(b)
    d = np.abs(desc_a[assign].astype(np.int32) - desc_b.astype(np.int32))
    assert float((d > 2).mean()) < 0.001, float((d > 2).mean())
    assert float((d != 0).mean()) < 0.05, float((d != 0).mean())


@pytest.mark.parametrize("fields", [{}, dict(intervals=4),
                                    dict(init_sigma=2.0, desc_scale_factor=4.0)],
                         ids=["default", "intervals4", "sigma2"])
def test_spatial_halo_equals_jax(fields):
    cfg = SiftConfig(**fields)
    assert spatial_halo(cfg) == jax_spatial_halo(jax_config(cfg, jnp.float32))


def test_every_rank_returns_the_same_buffer(ranks):
    for step in range(2):
        first = ranks[0][step].out
        for r in range(1, RANKS):
            other = ranks[r][step].out
            for f in ("x", "y", "size", "pori", "octave", "layer", "desc", "valid"):
                assert torch.equal(getattr(other, f), getattr(first, f)), (r, f)


def test_float64_equals_jax_detect_stages(ranks):
    img = quarter().astype(np.float64)
    octaves = F64.octaves_count(img.shape[1] * 2, img.shape[0] * 2)
    want = jax_detect_stages(jnp.asarray(img), jax_config(F64, jnp.float64), octaves)["final"]
    assert_same_keypoints(ranks[0][0].out, want, 30)


def test_float32_equals_the_ports_staged_path(ranks):
    img = quarter()
    octaves = F32.octaves_count(img.shape[1] * 2, img.shape[0] * 2)
    want = detect_stages(img, F32, octaves, device="cpu")["final"]
    assert_same_keypoints(ranks[0][1].out, want, 30)


@pytest.mark.slow
def test_equals_jax_spatial_two_octaves():
    """Against the JAX spatial_detect_and_describe on its simulated 4-device
    mesh, at an eighth of CAVE 00 and max_octaves=2, float32 (slow: the JAX
    function unrolls every octave into one program, minutes of XLA:CPU
    compile)."""
    img = np.load(f"{DATA}/oracle_cave00.npz")["input"][::8, ::8].astype(np.float32)
    got = run_steps([Step(spatial_detect_and_describe, (img, F32, MeshSpec(4, 1)),
                          dict(max_octaves=2))], RANKS, device="cpu")[0][0].out
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    want = jax_spatial(img, jax_config(F32, jnp.float32), mesh, max_octaves=2)
    assert_same_keypoints(got, want, 5)
