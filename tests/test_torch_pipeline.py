"""The port's whole detect + describe path on the CPU.

float64: held to the C++ reference's stage dumps (tests/data/oracle_*.npz)
bit for bit, like the JAX package's tests/test_parity_stages.py.  float32:
held to the JAX package's own detect_and_describe_batch (its XLA route, the
default on the CPU) under the contract of tests/test_pallas_pyramid.py:
same counts, x/y within 1e-3, byte-exact descriptors.
"""

from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu import SiftConfig as JaxConfig
from sift_tpu.models.sift import detect_and_describe_batch as jax_batch
from sift_tpu_torch import SiftConfig, detect_and_describe, detect_and_describe_batch
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.models.pyramid import compute_initial_image
from sift_tpu_torch.ops.gather import StackSpace
from sift_tpu_torch.utils.keypoints import Keypoints

torch.set_num_threads(2)
DATA = pathlib.Path(__file__).parent / "data"
CFG64 = SiftConfig(dtype=torch.float64, extrema_cap=1024, kp_cap=512, ori_cap=2048)


@pytest.fixture(scope="module", params=["small", "medium"])
def case(request):
    oracle = dict(np.load(DATA / f"oracle_{request.param}.npz"))
    imgs = S.as_batch(oracle["input"][None], CFG64, "cpu")
    gaussians, dogs, _, _ = S.front(imgs, CFG64)
    final = detect_and_describe(oracle["input"], CFG64, device="cpu")
    return oracle, imgs, gaussians, dogs, final


def test_pyramid_bit_equal_to_oracle(case):
    """Tolerance: none (float64 bits)."""
    oracle, imgs, gaussians, dogs, _ = case
    np.testing.assert_array_equal(
        compute_initial_image(imgs, CFG64)[0].numpy(), oracle["initial"])
    assert len(gaussians) == int(oracle["octaves_count"][0])
    for o, (g, d) in enumerate(zip(gaussians, dogs)):
        for i in range(g.shape[1]):
            np.testing.assert_array_equal(g[0, i].numpy(), oracle[f"gauss.{o}.{i}"])
        for i in range(d.shape[1]):
            np.testing.assert_array_equal(d[0, i].numpy(), oracle[f"dog.{o}.{i}"])


def _keyed(x, y, size, pori, desc):
    # pori compared at 1e-9: libm exp/atan2 differ from glibc in the last
    # ulp (the JAX package's test_parity_stages contract).
    return {
        (float(a), float(b), float(c), round(float(d), 9)): e
        for a, b, c, d, e in zip(x, y, size, pori, desc)
    }


@pytest.mark.parametrize("route", ["default", "front", "front_twin"])
def test_final_keypoints_and_descriptors_equal_oracle(case, route):
    """Same keypoint set (x, y, size bit-equal) and 0 descriptor bytes off,
    on the route ``detect_and_describe`` takes (the non-front one), on the
    front route and on the front-twin route's layouts (whose plain
    versions take float64 too)."""
    oracle, imgs, _, _, final = case
    if route == "default":
        assert S.route_of(CFG64, "cpu") == "stacks"
    elif route == "front":
        final = S.run_route(imgs, CFG64, "front")[0].map(lambda a: a[0])
    else:
        # float64 gets no strip from front_twin_strip, so every octave takes
        # the fallback: the same layouts, built from plain stacks.
        final = S.run_route(imgs, CFG64, "front_twin")[0].map(lambda a: a[0])
    mine = final.dense()
    got = _keyed(mine["x"], mine["y"], mine["size"], mine["pori"], mine["desc"])
    want = _keyed(*(oracle[f"final.{f}"] for f in ("x", "y", "size", "pori", "desc")))
    assert set(got) == set(want) and len(want) > 0
    assert sum(int(np.sum(got[k] != want[k])) for k in want) == 0


CAPS32 = dict(extrema_cap=1024, kp_cap=512, ori_cap=1024)


@pytest.fixture(scope="module")
def float32_run():
    """The port in float32 on the small oracle frame and its mirror image."""
    img = dict(np.load(DATA / "oracle_small.npz"))["input"].astype(np.float32)
    imgs = np.stack([img, img[:, ::-1]])
    cfg = SiftConfig(**CAPS32)
    out, counts = detect_and_describe_batch(imgs, cfg, return_counts=True, device="cpu")
    gaussians, dogs, _, _ = S.front(S.as_batch(imgs, cfg, "cpu"), cfg)
    return imgs, out, counts, gaussians, dogs


def _assert_same_keypoints(t, j, jv, atol):
    tv = t.valid.numpy()
    np.testing.assert_array_equal(tv.sum(1), jv.sum(1))
    assert tv.sum() > 0
    for name in ("x", "y"):
        np.testing.assert_allclose(
            getattr(t, name).numpy()[tv], np.asarray(getattr(j, name))[jv], rtol=0, atol=atol)
    return t.desc.numpy()[tv].astype(int)


def test_float32_batch_matches_jax_xla_route(float32_run):
    """Same counts per image, x/y within 1e-3.  Descriptor bytes within 1 of
    JAX's on at most 1% of bytes: XLA compiles the float32 blur's division
    by sum_w into a reciprocal multiply, the port (like the reference and
    kernel A) divides, and those ulps can move a byte across its floor.
    The byte-exact check on identical pyramids is the next test."""
    imgs, t, counts, _, _ = float32_run
    j = jax_batch(jnp.asarray(imgs), JaxConfig(dtype=jnp.float32, **CAPS32))
    jv = np.asarray(j.valid)
    diff = _assert_same_keypoints(t, j, jv, 1e-3) - np.asarray(j.desc)[jv].astype(int)
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 0.01
    assert (counts["extrema"] <= CAPS32["extrema_cap"]).all()
    assert (counts["oriented"] >= counts["refined"]).all()


def test_float32_stages_match_jax_on_the_same_pyramid(float32_run):
    """JAX's detect/orient/dedup/descriptor programs fed the port's own
    float32 pyramid: same counts, x/y within 1e-4 (float32 Newton ulps),
    byte-exact descriptors.  Tolerance on descriptors: none."""
    from sift_tpu.models import sift as JS

    _, t, _, gaussians, dogs = float32_run
    cfg = JaxConfig(dtype=jnp.float32, **CAPS32)
    kp, _, _ = JS._jit_detect_refine_batch([jnp.asarray(d.numpy()) for d in dogs], cfg)
    mr = JS._jit_gauss_rows_batch([jnp.asarray(g.numpy()) for g in gaussians])
    cand, _, _ = JS._jit_orient_batch(mr, kp, cfg)
    allkp = JS._jit_dedup_compact_batch(cand, cfg.ori_cap)
    desc = np.asarray(JS._jit_desc_all_batch(mr, allkp, cfg))
    jv = np.asarray(allkp.valid)
    np.testing.assert_array_equal(_assert_same_keypoints(t, allkp, jv, 1e-4), desc[jv])

    # JAX's own keypoint buffers through the port's descriptor stage.
    lanes = Keypoints.from_numpy(allkp)
    back = lanes.to_numpy()
    for f in back:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(allkp, f)), err_msg=f)
    got = S.describe(StackSpace.build(gaussians), lanes, SiftConfig(**CAPS32))
    np.testing.assert_array_equal(got.desc.numpy(), desc)
