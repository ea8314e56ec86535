"""The port's batch routes: the choice between the front-twin route and the
non-front route mirrors the JAX package's ``_use_front`` (CUDA in the TPU's
place), the routes give the same answer, and the non-front route runs the
configurations the front routes cannot take."""

from __future__ import annotations

import dataclasses
import itertools
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu import SiftConfig as JaxConfig
from sift_tpu.models import sift as JS
from sift_tpu_torch import SiftConfig, detect_and_describe_batch
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.utils.keypoints import FIELDS

torch.set_num_threads(2)
DATA = pathlib.Path(__file__).parent / "data"
CAPS = dict(extrema_cap=1024, kp_cap=512, ori_cap=2048)
DTYPES = {"float32": (torch.float32, jnp.float32), "float64": (torch.float64, jnp.float64)}


@pytest.mark.parametrize(
    "window,dtype,knob,backend",
    list(itertools.product((3, 5), DTYPES, (None, True, False), ("cpu", "tpu"))),
)
def test_use_front_gives_jax_answer(monkeypatch, window, dtype, knob, backend):
    """CUDA stands in for the TPU, the CPU for the CPU."""
    monkeypatch.setattr(JS.jax, "default_backend", lambda: backend)
    jcfg = JaxConfig(window_size=window, dtype=DTYPES[dtype][1], use_pallas_pyramid=knob)
    want = JS._use_front(jcfg)
    cfg = SiftConfig(window_size=window, dtype=DTYPES[dtype][0], use_octave_kernel=knob)
    # A JAX configuration carried over lands on the same route.
    assert SiftConfig.from_reference(dataclasses.asdict(jcfg)) == cfg
    dev = "cuda" if backend == "tpu" else "cpu"
    assert S.use_front(cfg, dev) == want
    # Where JAX's entry point runs _jit_front_twin_batch, the port's runs
    # the front-twin route; the plain-stack front is never route_of's answer.
    assert (S.route_of(cfg, dev) == "front_twin") == want
    assert S.route_of(cfg, dev) != "front"


@pytest.mark.parametrize("dtype,backend", list(itertools.product(DTYPES, ("cpu", "tpu"))))
def test_use_twin_rows_gives_jax_answer(monkeypatch, dtype, backend):
    """The non-front route's gather layout: JAX's _use_pallas_relayout,
    CUDA standing in for the TPU."""
    monkeypatch.setattr(JS.jax, "default_backend", lambda: backend)
    want = JS._use_pallas_relayout([jnp.zeros((1, 2, 4, 4), DTYPES[dtype][1])])
    cfg = SiftConfig(dtype=DTYPES[dtype][0])
    assert S.use_twin_rows(cfg, "cuda" if backend == "tpu" else "cpu") == want
    assert S.route_of(dataclasses.replace(cfg, window_size=5), "cpu") == "stacks"


def _assert_same_buffer(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def small():
    return dict(np.load(DATA / "oracle_small.npz"))["input"]


def test_routes_agree_float64(small):
    """On the CPU a float64 batch takes the non-front route; the front
    route's stages give the same final buffer.  Tolerance: none."""
    cfg = SiftConfig(dtype=torch.float64, **CAPS)
    assert not S.use_front(cfg, "cpu")
    imgs = np.stack([small, small[::-1]])
    got = detect_and_describe_batch(imgs, cfg, device="cpu")
    assert int(got.valid.sum()) > 0
    _assert_same_buffer(got, S.run_route(S.as_batch(imgs, cfg, "cpu"), cfg, "front")[0])


def test_routes_agree_float32_through_the_knob(small):
    """use_octave_kernel=True puts a float32 batch on the front-twin route
    on the CPU too; it, the plain-stack front route and the non-front route
    give the same buffer.  Tolerance: none."""
    imgs = np.stack([small, small[:, ::-1]])
    cfg = SiftConfig(**CAPS)
    front = dataclasses.replace(cfg, use_octave_kernel=True)
    assert S.use_front(front, "cpu") and not S.use_front(cfg, "cpu")
    assert (S.route_of(front, "cpu"), S.route_of(cfg, "cpu")) == ("front_twin", "stacks")
    got = detect_and_describe_batch(imgs, front, device="cpu")
    _assert_same_buffer(detect_and_describe_batch(imgs, cfg, device="cpu"), got)
    _assert_same_buffer(S.run_route(S.as_batch(imgs, cfg, "cpu"), cfg, "front")[0], got)


def test_window5_float64_equals_jax_xla_route(small):
    """window_size=5 (which the front route cannot take) on small.png's
    pixels, float64, against JAX's XLA route lane for lane: true stage
    counts equal; valid masks, x, y, size, octave, layer and descriptors
    exact; pori within 1e-9 (libm's exp / atan2 against XLA's,
    test_parity_stages's contract).  The 5x5x5 window leaves one interior
    DoG layer at 3 intervals, and no keypoint survives on this small frame
    at the default contrast, so the run takes 4 intervals and a lower
    contrast threshold (8 keypoints)."""
    kw = dict(window_size=5, intervals=4, contrast_threshold=0.005, **CAPS)
    t, tc = detect_and_describe_batch(small[None], SiftConfig(dtype=torch.float64, **kw),
                                      return_counts=True, device="cpu")
    j, jc = JS.detect_and_describe_batch(jnp.asarray(small[None], jnp.float64),
                                         JaxConfig(dtype=jnp.float64, **kw), return_counts=True)
    for k in ("extrema", "refined", "oriented"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    v = t.valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(j.valid))
    assert v.sum() > 0
    for f in ("x", "y", "size", "octave", "layer", "desc"):
        np.testing.assert_array_equal(getattr(t, f).numpy()[v], np.asarray(getattr(j, f))[v],
                                      err_msg=f)
    np.testing.assert_allclose(t.pori.numpy()[v], np.asarray(j.pori)[v], rtol=0, atol=1e-9)


@pytest.mark.parametrize("blur,pyramid", [(None, None), (True, False), (False, True)])
def test_from_reference_maps_the_knobs(blur, pyramid):
    """use_pallas_pyramid becomes use_octave_kernel; use_pallas_blur, which
    changes no result of the port, leaves the config as it is."""
    fields = dataclasses.asdict(JaxConfig(use_pallas_blur=blur, use_pallas_pyramid=pyramid))
    t = SiftConfig.from_reference(fields)
    assert t.use_octave_kernel == pyramid
    assert t == SiftConfig.from_reference({**fields, "use_pallas_blur": None})
