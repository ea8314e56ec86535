"""Kernel J on the card (``csrc/detect.cu``, wrapper ``ops/detect.py``).

Every test here needs an NVIDIA card and skips without one.  The suite's
``conftest.py`` imports JAX, which this file does not need, so on the
card's machine run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_detect_kernel.py

The kernel is held bit for bit to the plain chain it replaces on the card
(``extrema_from_counts`` + ``_refine``, run on the card) in every field of
the (B, kp_cap) keypoints, the counts and the lane order: at the benchmark
cells' capacities and batch sizes, where each capacity clips, on the front
route's stacks, across launches; and it waits for nothing on the host.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from sift_tpu_torch import SiftConfig
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.models.detect import extrema_from_counts, refine_cascade_caps
from sift_tpu_torch.ops import detect as DJ
from sift_tpu_torch.ops.gather import StackSpace
from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.keypoints import FIELDS

pytestmark = pytest.mark.cuda
DATA = pathlib.Path(__file__).parent / "data"
# The benchmark's capacities: cave_vga's and SiftConfig()'s (demo_pair).
CAVE_VGA = dict(extrema_cap=12288, kp_cap=2048, ori_cap=3072)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("kernel J runs only on an NVIDIA card: no CUDA device here")
    return torch.device("cuda")


def frames(name, bsz):
    """``bsz`` frames: the image and its three flips, in turn."""
    img = np.load(DATA / f"{name}.npz")["input"]
    flips = [img, img[::-1], img[:, ::-1], img[::-1, ::-1]]
    return np.stack([flips[i % 4] for i in range(bsz)])


def stage1(imgs, cfg, dev, route="front_twin"):
    """The DoG gather space, masks and popcounts of a route's stage 1."""
    batch = S.as_batch(imgs, cfg, dev)
    if route == "front_twin":
        _, sp, masks, counts = S.front_twin(batch, cfg)
    else:
        _, dogs, masks, counts = S.front(batch, cfg)
        sp = StackSpace.build(dogs)
    return sp, masks, counts


def plain(sp, masks, counts, cfg):
    return S._refine(sp, *extrema_from_counts(masks, counts, cfg.extrema_cap), cfg)


def assert_same(got, want):
    """Every keypoint field and every count, bit for bit."""
    (kp, c), (kw, cw) = got, want
    for f in FIELDS:
        a, b = getattr(kp, f), getattr(kw, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    assert set(c) == set(cw)
    for k in cw:
        assert torch.equal(c[k], cw[k]), k


def run_both(sp, masks, counts, cfg):
    """(kernel J through ``detect_refine``, the plain chain), with J's one
    launch checked."""
    before = DJ.detect_kernel.launches
    got = S.detect_refine(sp, masks, counts, cfg)
    assert DJ.detect_kernel.launches == before + 1
    return got, plain(sp, masks, counts, cfg)


@pytest.mark.parametrize("bsz", [1, 2, 16])
@pytest.mark.parametrize("name, caps", [("oracle_cave00", CAVE_VGA), ("oracle_demo1", {})])
def test_equals_the_plain_chain(dev, name, caps, bsz):
    """CAVE 00 at cave_vga's capacities and demo 1 at SiftConfig()'s, at
    batch 1, 2 and 16.  Tolerance: none."""
    cfg = SiftConfig(**caps)
    got, want = run_both(*stage1(frames(name, bsz), cfg, dev), cfg)
    assert_same(got, want)
    assert int(got[0].valid.sum()) > 0


def test_extrema_cap_clips(dev):
    """Fewer slots than extrema: the slots hold the first extrema in
    (octave, z, y, x) order, ``extrema`` the true total."""
    cfg = SiftConfig(extrema_cap=2048, kp_cap=1024, ori_cap=2048)
    got, want = run_both(*stage1(frames("oracle_cave00", 2), cfg, dev), cfg)
    assert bool((got[1]["extrema"] > cfg.extrema_cap).all())
    assert_same(got, want)


def test_each_cascade_phase_cap_clips(dev):
    """CAVE-01 frame 12 at extrema_cap 8192: more lanes still move after
    step 1 than n // 4, and after step 2 than n // 8, so both phases rank
    lanes out."""
    cfg = SiftConfig()
    f12 = np.load(DATA / "scene_oracle" / "cave01_12.npz")["input"]
    got, want = run_both(*stage1(np.stack([f12, f12]), cfg, dev), cfg)
    caps = [c for c, _ in refine_cascade_caps(cfg, cfg.extrema_cap)]
    assert bool((got[1]["refine_active"] > torch.tensor(caps, device=dev)).all())
    assert_same(got, want)


def test_refine_active_cap_schedule(dev):
    """``refine_active_cap``'s single phase of 4 steps, clipping."""
    cfg = SiftConfig(**CAVE_VGA, refine_active_cap=300)
    got, want = run_both(*stage1(frames("oracle_cave00", 2), cfg, dev), cfg)
    assert got[1]["refine_active"].shape == (2, 1)
    assert bool((got[1]["refine_active"] > 300).all())
    assert_same(got, want)


def test_kp_cap_above_the_slots(dev):
    """kp_cap above extrema_cap: the output's lanes past the slots are
    zero, as ``kputil.compact`` pads them."""
    cfg = SiftConfig(extrema_cap=1024, kp_cap=1500, ori_cap=2048)
    got, want = run_both(*stage1(frames("oracle_cave00", 2), cfg, dev), cfg)
    assert_same(got, want)


@pytest.mark.parametrize("name, caps", [("oracle_cave00", CAVE_VGA), ("oracle_demo1", {})])
def test_front_route_stack_space(dev, name, caps):
    """The front route's ``StackSpace`` (kernel A's stacks)."""
    cfg = SiftConfig(**caps)
    got, want = run_both(*stage1(frames(name, 2), cfg, dev, "front"), cfg)
    assert_same(got, want)
    twin = S.detect_refine(*stage1(frames(name, 2), cfg, dev), cfg)
    assert_same(got, twin)


def test_two_launches_give_the_same_bytes(dev):
    cfg = SiftConfig(**CAVE_VGA)
    sp, masks, counts = stage1(frames("oracle_cave00", 16), cfg, dev)
    a = DJ.detect_kernel(sp, masks, counts, cfg)
    b = DJ.detect_kernel(sp, masks, counts, cfg)
    torch.cuda.synchronize()
    assert_same(a, b)


def test_no_host_wait_inside_the_stage(dev):
    """No host wait inside ``sift.detect_refine``: no ``sift.sync.*`` span
    in it under the profiler, and no synchronizing call under PyTorch's
    sync debug mode."""
    cfg = SiftConfig(**CAVE_VGA)
    sp, masks, counts = stage1(frames("oracle_cave00", 2), cfg, dev)
    S.detect_refine(sp, masks, counts, cfg)  # the kernel is built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        S.detect_refine(sp, masks, counts, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        S.detect_refine(sp, masks, counts, cfg)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert "sift.detect_refine" in names
    assert not [n for n in names if n.startswith("sift.sync.")]


def test_launch_and_lane_counters(dev, monkeypatch):
    """``launches`` counts launches; under a profiler ``detect.kernel_lanes``
    adds B x extrema_cap and ``detect.kernel_launches`` one a launch."""
    monkeypatch.setattr(profiling, "_counts", {})
    cfg = SiftConfig(**CAVE_VGA)
    sp, masks, counts = stage1(frames("oracle_cave00", 2), cfg, dev)
    before = DJ.detect_kernel.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            S.detect_refine(sp, masks, counts, cfg)
    assert DJ.detect_kernel.launches == before + 3
    got = profiling.counters()
    assert got["detect.kernel_launches"] == 3
    assert got["detect.kernel_lanes"] == 3 * 2 * cfg.extrema_cap


def test_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    cfg = SiftConfig(**CAVE_VGA)
    sp, masks, counts = stage1(frames("oracle_cave00", 2), cfg, dev)
    with pytest.raises(ValueError):
        DJ.detect_kernel(sp, [m.cpu() for m in masks], counts, cfg)
    with pytest.raises(ValueError):
        DJ.detect_kernel(sp, masks, [c.long() for c in counts], cfg)
    with pytest.raises(ValueError):
        DJ.detect_kernel(sp, masks, counts, dataclasses.replace(cfg, window_size=5))
