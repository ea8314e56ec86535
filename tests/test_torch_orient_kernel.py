"""Kernel K on the card (``csrc/describe.cu``, wrapper ``ops/orient.py``).

Every test here needs an NVIDIA card and skips without one.  The suite's
``conftest.py`` imports JAX, which this file does not need, so on the
card's machine run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_orient_kernel.py

The kernel is held bit for bit to ``orient_ordered_plain`` (its order of
sums in plain PyTorch, run on the card) on the main path's gauss space at
the benchmark cells' capacities and batch sizes, on every gauss-space
layout and the staged path's one-octave spaces, with no valid lane and with
more peaks than slots; to the plain chain up to that order; to itself
across launches; and it waits for nothing on the host.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from sift_tpu_torch import SiftConfig, kernels
from sift_tpu_torch.models import orient as O
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.ops import orient as OK
from sift_tpu_torch.ops.gather import StackSpace, build_multi_rows
from sift_tpu_torch.ops.twin_rows import twin_rows_strips
from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.keypoints import FIELDS

pytestmark = pytest.mark.cuda
DATA = pathlib.Path(__file__).parent / "data"
CAVE_VGA = dict(extrema_cap=12288, kp_cap=2048, ori_cap=3072)
SCENE = [DATA / "scene_oracle" / f"cave01_{i:02d}.npz" for i in range(16)]
# The benchmark's cells: cave_vga at batch 16 (resident_b16) and 1 (the
# panorama's frames), demo_pair at batch 2 (SiftConfig()).
CELLS = dict(
    resident16=(SCENE, CAVE_VGA),
    panorama=(SCENE[:1], CAVE_VGA),
    demo_pair=([DATA / f"oracle_demo{i}.npz" for i in (1, 2)], {}),
)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("kernel K runs only on an NVIDIA card: no CUDA device here")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def refined(imgs, cfg):
    """The front-twin route's gauss space and refined keypoints."""
    gsp, dsp, masks, counts = S.front_twin(imgs, cfg)
    return gsp, S.detect_refine(dsp, masks, counts, cfg)[0]


def assert_same(got, want):
    """Every candidate field and max_peaks, bit for bit."""
    (cand, peaks), (cw, pw) = got, want
    for f in FIELDS:
        a, b = getattr(cand, f), getattr(cw, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    assert peaks.dtype == pw.dtype == torch.int32 and int(peaks) == int(pw)


def kernel_once(sp, kp, cfg, oov=None):
    """``orient_all`` on the card, its one launch of K checked."""
    before = kernels.launch_counts()["orient"]
    got = O.orient_all(sp, kp, cfg, oov)
    assert kernels.launch_counts()["orient"] == before + 1
    return got


@pytest.fixture(scope="module", params=list(CELLS))
def main_path(request, dev):
    paths, caps = CELLS[request.param]
    cfg = SiftConfig(**caps)
    imgs = S.as_batch(np.stack([np.load(p)["input"] for p in paths]), cfg, dev)
    gsp, kp = refined(imgs, cfg)
    assert int(kp.valid.sum()) > 0
    return cfg, gsp, kp


def test_kernel_equals_the_order_model(main_path):
    """One launch through ``orient_all`` gives ``orient_ordered_plain``'s
    candidates and max_peaks.  Tolerance: none."""
    cfg, gsp, kp = main_path
    got = kernel_once(gsp, kp, cfg)
    assert_same(got, OK.orient_ordered_plain(gsp, kp, cfg, O.ori_radius_classes(cfg)))
    assert int(got[0].valid.sum()) >= int(kp.valid.sum())


def test_kernel_is_the_plain_chain_up_to_the_order_of_sums(main_path):
    """Against the plain chain on the card (one-hot ``bmm`` per radius
    class): the same validity, x, y, size, octave, layer and max_peaks,
    pori within 1e-5 rad on valid candidates."""
    cfg, gsp, kp = main_path
    (a, pa), (b, pb) = O.orient_all(gsp, kp, cfg), O.orient_plain(gsp, kp, cfg)
    assert int(pa) == int(pb)
    for f in ("valid", "x", "y", "size", "octave", "layer"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert float((a.pori - b.pori)[a.valid].abs().max()) <= 1e-5


def test_two_launches_give_the_same_bits(main_path):
    cfg, gsp, kp = main_path
    a, b = O.orient_all(gsp, kp, cfg), O.orient_all(gsp, kp, cfg)
    torch.cuda.synchronize()
    assert_same(a, b)


@pytest.fixture(scope="module")
def pair(dev):
    """The CAVE 00 / 01 pair at the smoke capacities on the card: the
    config, the front-twin route's refined keypoints, the non-front
    route's gauss stacks and the gauss space of every layout."""
    cfg = SiftConfig(extrema_cap=6144, kp_cap=1536, ori_cap=2048)
    frames = [np.load(DATA / f"oracle_cave0{i}.npz")["input"] for i in (0, 1)]
    imgs = S.as_batch(np.stack(frames), cfg, dev)
    gsp, kp = refined(imgs, cfg)
    gaussians, _ = S.pyramids(imgs, cfg)
    spaces = dict(layer_minor=gsp, stack=StackSpace.build(gaussians),
                  strips=twin_rows_strips(gaussians, S.TWIN_BLK),
                  rows=build_multi_rows([g[0] for g in gaussians]))
    return cfg, kp, gaussians, spaces


@pytest.mark.parametrize("name", ["layer_minor", "stack", "strips", "rows"])
def test_every_layout_gives_the_main_path_bits(pair, name):
    """Kernel E's strips, the plain stacks and kernel H's row-major rows
    (image 0) give the order model's candidates on the same space and the
    front-twin route's gauss space's.  Tolerance: none."""
    cfg, kp, _, spaces = pair
    radii = O.ori_radius_classes(cfg)
    ref = kernel_once(spaces["layer_minor"], kp, cfg)
    if name == "rows":
        kp, ref = kp.map(lambda a: a[:1]), (ref[0].map(lambda a: a[:1]), None)
    got = kernel_once(spaces[name], kp, cfg)
    assert_same(got, OK.orient_ordered_plain(spaces[name], kp, cfg, radii))
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(ref[0], f)), f


def test_staged_one_octave_spaces(pair):
    """The staged path's spaces (one octave's row-major rows, kernel H),
    through ``orient_octave_keypoints``: each octave's lanes of image 0 give
    the order model's candidates and the main path's.  Tolerance: none."""
    cfg, kp, gaussians, spaces = pair
    ref, _ = kernel_once(spaces["layer_minor"], kp, cfg)
    kp0 = kp.map(lambda a: a[0])
    slots = cfg.ori_cand_slots
    seen = 0
    for o, g in enumerate(gaussians):
        before = kernels.launch_counts()["orient"]
        got, peaks = O.orient_octave_keypoints(g[0], kp0, o, cfg)
        assert kernels.launch_counts()["orient"] == before + 1
        want, pw = OK.orient_ordered_plain(build_multi_rows([g[0]]), kp0.map(lambda a: a[None]),
                                           cfg, O.ori_radius_classes(cfg), octave_of_volume=(o,))
        assert int(peaks) == int(pw)
        sel = (kp0.octave == o).repeat_interleave(slots)
        seen += int((sel & ref.valid[0]).sum())
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)[0]), (o, f)
            assert torch.equal(getattr(got, f)[sel], getattr(ref, f)[0][sel]), (o, f)
    assert seen == int(ref.valid[0].sum()) > 0


def test_no_valid_lane(pair):
    """Every lane invalid: one launch, every slot invalid with pori 0 and the
    lanes' fields, max_peaks 0."""
    cfg, kp, _, spaces = pair
    none = dataclasses.replace(kp, valid=torch.zeros_like(kp.valid))
    got = kernel_once(spaces["layer_minor"], none, cfg)
    assert_same(got, OK.orient_ordered_plain(spaces["layer_minor"], none, cfg,
                                             O.ori_radius_classes(cfg)))
    assert int(got[1]) == 0 and not bool(got[0].valid.any())
    assert int(got[0].pori.abs().sum()) == 0


def test_more_peaks_than_slots(pair):
    """Two slots a lane: lanes with three or more peaks keep their first two
    in bin order, and max_peaks reports the true most."""
    cfg, kp, _, spaces = pair
    cfg2 = dataclasses.replace(cfg, ori_cand_slots=2)
    got = kernel_once(spaces["layer_minor"], kp, cfg2)
    assert int(got[1]) > 2
    assert_same(got, OK.orient_ordered_plain(spaces["layer_minor"], kp, cfg2,
                                             O.ori_radius_classes(cfg2)))
    full, _ = kernel_once(spaces["layer_minor"], kp, cfg)
    first = full.pori.reshape(*kp.valid.shape, cfg.ori_cand_slots)[..., :2]
    assert torch.equal(got[0].pori.reshape(*kp.valid.shape, 2), first)


def test_no_host_wait_inside_the_stage(pair):
    """No host wait inside ``sift.orient``: no ``sift.sync.*`` span in it
    under the profiler, and no synchronizing call under PyTorch's sync debug
    mode."""
    cfg, kp, _, spaces = pair
    gsp = spaces["layer_minor"]
    S.orient(gsp, kp, cfg)  # the kernel is built and its constants made
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        S.orient(gsp, kp, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        S.orient(gsp, kp, cfg)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert "sift.orient" in names
    assert not [n for n in names if n.startswith("sift.sync.")]


def test_launch_and_lane_counters(pair, monkeypatch):
    """``kernels.launch_counts`` counts launches; under a profiler
    ``orient.kernel_lanes`` adds B x kp_cap and ``orient.kernel_launches``
    one a launch; the plain chain's sample counters stay silent."""
    cfg, kp, _, spaces = pair
    monkeypatch.setattr(profiling, "_counts", {})
    before = kernels.launch_counts()["orient"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            O.orient_all(spaces["layer_minor"], kp, cfg)
    assert kernels.launch_counts()["orient"] == before + 3
    got = profiling.counters()
    assert got["orient.kernel_launches"] == 3
    assert got["orient.kernel_lanes"] == 3 * kp.valid.numel()
    assert "orient.samples_computed" not in got


def test_wrapper_raises_on_what_the_kernel_does_not_take(pair):
    cfg, kp, _, spaces = pair
    gsp = spaces["layer_minor"]
    rmax = O.ori_radius_bound(cfg)
    for bad in (dataclasses.replace(kp, x=kp.x.double()),
                dataclasses.replace(kp, octave=kp.octave.long()),
                dataclasses.replace(kp, valid=kp.valid.cpu())):
        with pytest.raises(ValueError):
            OK.orient_kernel(gsp, bad, cfg, rmax)
    with pytest.raises(ValueError):
        OK.orient_kernel(gsp, kp, cfg, OK.MAX_RMAX + 1)
