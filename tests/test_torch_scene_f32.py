"""Where the port's and the JAX package's float32 keypoints part on scene
frames: the pyramid, not the stages.

CAVE-01 frames 6 and 13 (``tests/data/scene_oracle``, 640x480), float32,
capacities 12288 / 1536 / 2048, detection through dedup (the keypoint set,
as ``scripts/demo_f32_parting.py`` compares it).  On frame 6 the JAX
package's XLA route gives the oracle's 1040 keypoints and the port 1043
(one extra location with three orientations); on frame 13 the JAX route
960 and the port 959.  Each package's stages fed the other's pyramid give
the other's keypoints.  So the counts follow the pyramid's float32
rounding (the JAX package's grayscale and blurs round apart from the
port's separately rounded operations, which are the C++ reference's), and
given the same pyramid the stages agree.
"""

from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu import SiftConfig as JaxConfig
from sift_tpu.models import sift as JS
from sift_tpu_torch import SiftConfig
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.ops.gather import StackSpace

torch.set_num_threads(2)
SCENE = pathlib.Path(__file__).parent / "data" / "scene_oracle"
# frame: (the JAX route's keypoints, the port's)
COUNTS = {6: (1040, 1043), 13: (960, 959)}
CAPS = dict(extrema_cap=12288, kp_cap=1536, ori_cap=2048)
FIELDS = ("x", "y", "size", "pori", "octave", "layer")
# The stages' own float32 arithmetic rounds apart in the two packages (XLA
# contracts multiply-adds), so a keypoint's x and y may differ by an ulp or
# two (6.1e-5 at 512-1024 px) and its size and orientation by a few 1e-6:
# x, y within 1.25e-4 px, size within 1e-5, orientation within 1e-5 rad;
# octave and layer exact.
TOL = np.array([1.25e-4, 1.25e-4, 1e-5, 1e-5])


def _jax_stages(gaussians, dogs, jcfg):
    kp, _, _ = JS._jit_detect_refine_batch([jnp.asarray(np.asarray(d)) for d in dogs], jcfg)
    mr = JS._jit_gauss_rows_batch([jnp.asarray(np.asarray(g)) for g in gaussians])
    cand, _, _ = JS._jit_orient_batch(mr, kp, jcfg)
    return JS._jit_dedup_compact_batch(cand, jcfg.ori_cap)


def _port_stages(gaussians, dogs, cfg):
    dogs = [torch.from_numpy(np.array(d)) for d in dogs]
    gaussians = [torch.from_numpy(np.array(g)) for g in gaussians]
    kp, _ = S._detect_refine_fused(dogs, cfg, False)
    cand, _ = S.orient(StackSpace.build(gaussians), kp, cfg)
    return S.dedup(cand, cfg)


def _rows(kp) -> np.ndarray:
    """(n, 6) float32 rows (x, y, size, pori, octave, layer) of image 0."""
    v = np.asarray(kp.valid[0])
    return np.stack([np.asarray(getattr(kp, f)[0])[v].astype(np.float32) for f in FIELDS], 1)


def _same_set(a: np.ndarray, b: np.ndarray) -> bool:
    """One to one within the tolerance above."""
    if a.shape != b.shape:
        return False
    close = (np.abs(a[:, None, :4] - b[None, :, :4]) <= TOL).all(-1)
    close &= (a[:, None, 4:] == b[None, :, 4:]).all(-1)
    return bool((close.sum(0) == 1).all() and (close.sum(1) == 1).all())


@pytest.fixture(scope="module", params=list(COUNTS), ids=lambda f: f"frame{f:02d}")
def runs(request):
    img = np.load(SCENE / f"cave01_{request.param:02d}.npz")["input"][None].astype(np.float32)
    cfg = SiftConfig(**CAPS)
    jcfg = JaxConfig(dtype=jnp.float32, use_pallas_pyramid=False, **CAPS)
    pg, pd = S.pyramids(S.as_batch(img, cfg, "cpu"), cfg)
    jg, jd = JS._jit_pyramids_batch(jnp.asarray(img), jcfg, len(pg))
    return dict(
        frame=request.param,
        jax=_rows(_jax_stages(jg, jd, jcfg)), port=_rows(_port_stages(pg, pd, cfg)),
        jax_on_port=_rows(_jax_stages(pg, pd, jcfg)), port_on_jax=_rows(_port_stages(jg, jd, cfg)),
    )


def test_counts_part(runs):
    """The JAX package gives the oracle's count; the port 3 more on frame 6
    (one location, (211.994, 156.75, size 1.749), with three orientations)
    and one fewer on frame 13."""
    frame = runs["frame"]
    oracle = len(np.load(SCENE / f"cave01_{frame:02d}.npz")["final.x"])
    assert (len(runs["jax"]), len(runs["port"])) == COUNTS[frame]
    assert len(runs["jax"]) == oracle
    if frame == 6:
        p = runs["port"]
        extra = p[(np.abs(p[:, 0] - 211.994) < 1e-3) & (np.abs(p[:, 1] - 156.75) < 1e-3)]
        assert len(extra) == 3 and np.allclose(extra[:, 2], 1.749, atol=1e-3)


def test_port_stages_on_jax_pyramid_give_jax_keypoints(runs):
    assert _same_set(runs["port_on_jax"], runs["jax"])


def test_jax_stages_on_port_pyramid_give_port_keypoints(runs):
    assert _same_set(runs["jax_on_port"], runs["port"])
