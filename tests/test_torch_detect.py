"""The port's extrema compaction and Newton refinement against the JAX
package's ``models/detect.py`` (float64 on the CPU)."""

from __future__ import annotations

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sift_tpu import SiftConfig as JaxConfig
from sift_tpu.models import detect as jdet
from sift_tpu.models.sift import _host_exact_sizes_mixed
from sift_tpu_torch import SiftConfig
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.models.detect import (
    extrema_from_counts,
    extremum_mask,
    refine_keypoints_all,
)
from sift_tpu_torch.ops.gather import StackSpace

torch.set_num_threads(2)
DATA = pathlib.Path(__file__).parent / "data"


def _mask_counts(d: torch.Tensor, thr: float):
    """(S, H, W) DoGs -> the front's (1, S-2, H, nbm*128) mask + counts."""
    m = extremum_mask(d[None], thr, 3).to(d.dtype)
    h, w = d.shape[1:]
    nbm = -(-w // 128)
    mp = F.pad(m, (1, nbm * 128 - m.shape[-1] - 1, 1, h - m.shape[-2] - 1))
    return mp, mp.reshape(1, mp.shape[1], h, nbm, 128).sum(-1, dtype=torch.int32)


@pytest.mark.parametrize("cap", [16, 512])
def test_extrema_from_counts_equals_detect_extrema_all(cap):
    """Lane-exact, including capacity overflow (cap 16).  Tolerance: none."""
    rng = np.random.default_rng(7)
    shapes = [(5, 40, 300), (5, 20, 150)]  # W % 128 != 0 on purpose
    dogs = [rng.normal(0, 2.0, s).astype(np.float32) for s in shapes]
    thr = 1.0
    o1, z1, v1, t1 = (np.asarray(a) for a in jdet.detect_extrema_all(
        [jnp.asarray(d) for d in dogs], thr, cap, 3))
    mc = [_mask_counts(torch.from_numpy(d), thr) for d in dogs]
    o2, z2, v2, t2 = (a[0].numpy() for a in extrema_from_counts(
        [m for m, _ in mc], [c for _, c in mc], cap))
    assert int(t2) == int(t1) > cap
    np.testing.assert_array_equal(v2, v1)
    np.testing.assert_array_equal(o2[v1], o1[v1])
    np.testing.assert_array_equal(z2[v1], z1[v1])


@pytest.fixture(scope="module")
def medium_front():
    """float64 octave fronts of the medium oracle image (6 octaves)."""
    cfg = SiftConfig(dtype=torch.float64)
    img = dict(np.load(DATA / "oracle_medium.npz"))["input"]
    _, dogs, masks, counts = S.front(S.as_batch(img[None], cfg, "cpu"), cfg)
    return dogs, masks, counts


@functools.lru_cache(maxsize=None)
def _jax_refine(cfg):
    return jax.jit(lambda d, o, z, v: jdet.refine_keypoints_all(d, o, z, v, cfg))


@pytest.mark.parametrize("active_cap", [None, 16])
def test_refine_equals_jax(medium_front, active_cap):
    """Same valid lanes; x, y, layer offset and Newton phase counts bit-equal;
    size bit-equal after both sides' host pow fix.  ``active_cap=16``
    overflows the Newton phase buffer (clipped lanes must agree too)."""
    dogs, masks, counts = medium_front
    cap = 1024
    kw = dict(extrema_cap=cap, refine_active_cap=active_cap)
    tcfg = SiftConfig(dtype=torch.float64, **kw)
    jcfg = JaxConfig(dtype=jnp.float64, **kw)
    jd = [jnp.asarray(d[0].numpy()) for d in dogs]
    jo, jz, jv, _ = jdet.detect_extrema_all(jd, tcfg.extremum_threshold(), cap, 3)
    jkp, joff, jna = _jax_refine(jcfg)(jd, jo, jz, jv)

    oct_id, zyx, valid, _ = extrema_from_counts(masks, counts, cap)
    kp, off0, n_active = refine_keypoints_all(StackSpace.build(dogs), oct_id, zyx, valid, tcfg)

    v = kp.valid[0].numpy()
    np.testing.assert_array_equal(v, np.asarray(jkp.valid))
    assert v.sum() > 0
    np.testing.assert_array_equal(n_active[0].numpy(), np.asarray(jna))
    for name in ("x", "y", "octave", "layer"):
        np.testing.assert_array_equal(
            getattr(kp, name)[0].numpy()[v], np.asarray(getattr(jkp, name))[v], err_msg=name)
    np.testing.assert_array_equal(off0[0].numpy()[v], np.asarray(joff)[v])
    tsize = S.host_exact_sizes(kp, off0, tcfg).size[0].numpy()
    jsize = np.asarray(_host_exact_sizes_mixed(jkp, joff, jcfg).size)
    np.testing.assert_array_equal(tsize[v], jsize[v])
