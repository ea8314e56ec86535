"""Radius classes of orientation and descriptors (float32 only).

Outside the float64 parity profile each valid lane of stage 3
(``orient_all``) and stage 5 (``compute_descriptors_all``) reads the
smallest window of the JAX package's dispatch classes that covers its own
radius: (11, 13, 17) for orientation and (20, 24, 28, 32, 36, 40) for
descriptors at the default configuration.  A larger window adds only
masked exact zeros, so classes move a lane's sums by their order alone;
float64 keeps the one worst-case window.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from sift_tpu_torch import SiftConfig
from sift_tpu_torch.models import descriptor as De
from sift_tpu_torch.models import orient as O
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.models.sift import detect_stages, octaves_for
from sift_tpu_torch.ops.gather import StackSpace, by_radius_class, class_of
from sift_tpu_torch.utils import keypoints as K
from sift_tpu_torch.utils.keypoints import FIELDS

torch.set_num_threads(2)
DATA = pathlib.Path(__file__).parent / "data"
CAPS = dict(extrema_cap=6144, kp_cap=1536, ori_cap=2048)


def _oracle(name):
    return dict(np.load(DATA / f"oracle_{name}.npz"))


@pytest.fixture(scope="module", params=["small", "cave_pair"])
def run32(request):
    """float32 pyramid, refined keypoints and gather space of oracle_small
    (and its mirror image) or the CAVE 00 / 01 pair."""
    if request.param == "small":
        img = _oracle("small")["input"]
        frames = [img, img[:, ::-1]]
    else:
        frames = [_oracle(f"cave0{i}")["input"] for i in (0, 1)]
    cfg = SiftConfig(**CAPS)
    imgs = S.as_batch(np.stack(frames), cfg, "cpu")
    gaussians, dogs = S.pyramids(imgs, cfg)
    kp, _ = S._detect_refine_fused(dogs, cfg, False)
    return cfg, kp, StackSpace.build(gaussians)


def test_classes_are_the_jax_dispatch_classes():
    cfg = SiftConfig()
    assert O.ori_radius_classes(cfg) == [11, 13, O.ori_radius_bound(cfg)] == [11, 13, 17]
    assert De.desc_radius_classes(cfg) == [20, 24, 28, 32, 36, 40]
    assert De.desc_radius_bound(cfg) == 40
    f64 = dataclasses.replace(cfg, dtype=torch.float64)
    assert O.ori_radius_classes(cfg, classes=False) == O.ori_radius_classes(f64) == [17]
    assert De.desc_radius_classes(cfg, classes=False) == De.desc_radius_classes(f64) == [40]


@pytest.mark.parametrize("radii", [[11, 13, 17], [20, 24, 28, 32, 36, 40], [40]])
def test_each_lane_runs_at_the_class_of_its_own_radius(radii):
    """``by_radius_class`` calls ``fn`` with each lane under the window
    ``searchsorted(radii, radius)`` picks (the last above them all), in
    chunks of one fixed size per class, and returns lane order."""
    rng = np.random.default_rng(7)
    radius = rng.integers(0, 46, 1000)
    ids = torch.arange(1000)
    calls = []

    def fn(args, r):
        calls.append((r, len(args[0])))
        return torch.stack([args[0], torch.full_like(args[0], r), args[1]], 1)

    out = by_radius_class(torch.from_numpy(radius), radii, 64, (ids, torch.from_numpy(radius)),
                          fn).numpy()
    want = np.minimum(np.searchsorted(radii, radius), len(radii) - 1)
    np.testing.assert_array_equal(class_of(torch.from_numpy(radius), radii).numpy(), want)
    np.testing.assert_array_equal(out[:, 0], np.arange(1000))
    np.testing.assert_array_equal(out[:, 1], np.asarray(radii)[want])
    np.testing.assert_array_equal(out[:, 2], radius)
    side = 2 * radii[-1] + 1
    for r, n in calls:
        assert n == 64 * max(1, side * side // (2 * r + 1) ** 2)


def test_orientation_lane_classes_are_searchsorted_of_the_radius(run32):
    """The valid lanes' orientation radius round(3 * 1.5 * size / 2^octave)
    (src/sift.cpp:463, float32 as the port computes it) and its class."""
    cfg, kp, gsp = run32
    v = kp.valid.numpy()
    size = kp.size.numpy()[v]
    scale = np.float32(cfg.ori_sigma_factor) * (
        size * (np.float32(1.0) / np.float32(2.0) ** kp.octave.numpy()[v]).astype(np.float32))
    t = np.float32(3.0) * scale
    radius = np.where(t >= 0, np.floor(t + np.float32(0.5)), np.ceil(t - np.float32(0.5)))
    radii = O.ori_radius_classes(cfg)
    want = np.bincount(np.searchsorted(radii, radius.astype(np.int64)), minlength=len(radii))
    assert O.class_counts(gsp, kp, cfg) == want.tolist()
    assert O.class_counts(gsp, kp, cfg, classes=False) == [int(v.sum())]


@pytest.mark.parametrize("name,want", [("cave00", [46, 258, 146, 93, 90, 44]),
                                       ("cave01", [95, 448, 239, 125, 120, 40])])
def test_descriptor_classes_of_the_oracle_keypoints(name, want):
    """The oracle's final keypoints per descriptor class: the counts of the
    reckoning from ``final.size`` / ``final.octave`` and the radius formula
    of src/sift.cpp:636-639 that set the classes' expected saving."""
    o = _oracle(name)
    cfg = SiftConfig(**CAPS)
    n = len(o["final.x"])
    kp = K.Keypoints.from_numpy({**{f: o[f"final.{f}"] for f in FIELDS if f != "valid"},
                                 "valid": np.ones(n, bool)}).map(lambda a: a[None])
    h, w = (2 * d for d in o["input"].shape[:2])
    shapes = [torch.zeros((1, 1, h >> k, w >> k)) for k in range(octaves_for(
        torch.zeros((1, h // 2, w // 2, 1)), cfg))]
    assert De.class_counts(StackSpace.build(shapes), kp, cfg) == want


def test_classes_keep_keypoints_candidates_and_descriptors(run32):
    """Classes against the worst-case window in float32: the same
    orientation candidates (validity, x, y, size; pori within 1e-5 rad on
    valid lanes) and, on the same keypoints, descriptor bytes off by at
    most 1 on at most 1 byte in 10^4.  Measured on the CPU: no candidate
    off; pori off on 10 of the CAVE pair's 1,754 valid candidates, by at
    most 1.9e-6 rad (none on oracle_small); 0 descriptor bytes off on both
    inputs (1 of 223,232, off by 1, when each side describes the candidates
    of its own orientation run)."""
    cfg, kp, gsp = run32
    cands = [O.orient_all(gsp, kp, cfg, classes=c) for c in (True, False)]
    (a, pa), (b, pb) = cands
    assert int(pa) == int(pb)
    for f in ("valid", "x", "y", "size", "octave", "layer"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.valid.sum()) > 0
    assert float((a.pori - b.pori)[a.valid].abs().max()) <= 1e-5
    allkp = S.dedup(K.compact(a, cfg.ori_cap), cfg)
    da, db = (De.compute_descriptors_all(gsp, allkp, cfg, classes=c).int() for c in (True, False))
    diff = (da - db)[allkp.valid].abs()
    assert int(diff.max()) <= 1
    assert int((diff != 0).sum()) <= max(1, diff.numel() // 10_000)


def test_float64_ignores_classes():
    """The float64 parity profile runs the one worst-case window whatever
    ``classes`` says: identical candidates and descriptor bytes."""
    img = _oracle("small")["input"]
    cfg = SiftConfig(dtype=torch.float64, extrema_cap=1024, kp_cap=512, ori_cap=2048)
    gaussians, dogs = S.pyramids(S.as_batch(img[None], cfg, "cpu"), cfg)
    kp, _ = S._detect_refine_fused(dogs, cfg, False)
    gsp = StackSpace.build(gaussians)
    (a, _), (b, _) = (O.orient_all(gsp, kp, cfg, classes=c) for c in (True, False))
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    allkp = S.dedup(K.compact(a, cfg.ori_cap), cfg)
    assert int(allkp.valid.sum()) > 0
    assert torch.equal(De.compute_descriptors_all(gsp, allkp, cfg, classes=True),
                       De.compute_descriptors_all(gsp, allkp, cfg, classes=False))


@pytest.fixture(scope="module")
def crop():
    """A 240 x 320 crop of CAVE 00: every descriptor class has lanes."""
    return _oracle("cave00")["input"][120:360, 160:480]


@pytest.mark.parametrize("route", ["twin_rows", "front", "front_twin", "staged"])
def test_routes_give_the_same_bytes_with_classes(crop, route):
    """In float32 with classes, each batch route the CPU runs and the staged
    path give the stacks route's keypoints and descriptor bytes.
    Tolerance: none."""
    cfg = SiftConfig(**CAPS)
    imgs = S.as_batch(np.stack([crop, crop[::-1]]), cfg, "cpu")
    ref = S.run_route(imgs, cfg, "stacks")[0]
    assert min(De.class_counts(StackSpace.build(S.pyramids(imgs, cfg)[0]), ref, cfg)) > 0
    if route == "staged":
        for i, frame in enumerate((crop, np.ascontiguousarray(crop[::-1]))):
            fin = detect_stages(frame, cfg, octaves_for(imgs, cfg), device="cpu")["final"]
            for f in ("x", "y", "size", "pori", "octave", "layer", "desc"):
                assert torch.equal(getattr(fin, f)[fin.valid], getattr(ref, f)[i][ref.valid[i]]), f
        return
    got = S.run_route(imgs, cfg, route)[0]
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
