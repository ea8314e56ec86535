"""The panorama cell on the CPU at a small size: CAVE-01's frames 0-3 at
half size (240 x 320), at capacities that hold them, in a copy of the
benchmark (``tiny``).  The client, order and judge run end to end and a
sound program is correct; the control (the plain stitching in TF32 in the
program's place) is not and a sound float32 reordering is; each planted
fault of the stitching fails a limit, and another RANSAC draw, which a
sound program's rounding can bring about, does not; the readers read a
synthetic trace and nothing without one."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import sift_tpu_torch.models.blend as B
import sift_tpu_torch.models.stitch as S
from benchmark import control_panorama, harness
from benchmark.tests import tiny
from benchmark.trace import Trace
from sift_tpu_torch.utils import profiling

torch.set_num_threads(2)
SEED = 2**32 + 23
CELL = "tiny_cave01_panorama.scene35"
CAPS = dict(extrema_cap=2048, kp_cap=512, ori_cap=1024)
NEW = ("homography_inliers_lost_pct", "panorama_pixels_off_pct")
HERE = harness.ROOT / "benchmark"


def scene(frames):
    return [f[::2, ::2].copy() for f in frames[:4]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny checkout with the cell ``tiny_cave01_panorama.scene35``."""
    root = tiny.make(tmp_path_factory.mktemp("checkout"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "cave01_panorama.json").read_text())
    cfg["sift"].update(CAPS)
    (root / "benchmark" / "configs" / "tiny_cave01_panorama.json").write_text(json.dumps(cfg))
    spec["configs"].append(dict(name="tiny_cave01_panorama", source="test", reduced=[],
                                why="test", file="benchmark/configs/tiny_cave01_panorama.json"))
    spec["workloads"].append(dict(name=CELL, config="tiny_cave01_panorama", traffic="scene35",
                                  chips=1, why="test"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "cave01_panorama.scene35" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "limits" / f"{CELL}.json").write_text(
        (HERE / "limits" / "cave01_panorama.scene35.json").read_text())
    return root


def run(root, seconds=0.5):
    return harness.run_cell(CELL, SEED, seconds, False, "cpu",
                            hooks=dict(root=root, frames=scene))


def test_the_cell_runs_and_a_sound_program_is_correct(root):
    result, lines = run(root)
    assert result["correct"], lines
    assert set(NEW) <= set(result["checks"])
    assert result["attempted"] >= 1 and "frames_per_s" in result["metrics"]
    assert "3 edge homographies, 1 canvases" in lines[0]


def test_the_order_takes_every_frame_and_the_four_flips():
    order = harness.load_module(HERE, "orders", "scene")
    reqs = order.requests({}, 35, SEED)
    first = [next(reqs) for _ in range(8)]
    assert [r["index"] for r in first] == list(range(-1, 7))
    assert all(r["frames"] == list(range(35)) for r in first)
    assert sorted(r["flip"] for r in first[:4]) == [0, 1, 2, 3]
    assert sorted(r["flip"] for r in first[4:]) == [0, 1, 2, 3]
    again = order.requests({}, 35, SEED)
    assert [next(again)["flip"] for _ in range(8)] == [r["flip"] for r in first]


@pytest.mark.parametrize("variant, frozen, correct", [("tf32", True, False),
                                                     ("reordered", False, True)])
def test_the_control_is_not_correct_and_a_sound_program_is(root, variant, frozen, correct):
    line = control_panorama.readings(CELL, SEED, 0.5, "cpu", hooks=dict(root=root, frames=scene),
                                     variant=variant, frozen_keypoints=frozen)
    assert line["correct"] is correct, line
    if not correct:
        limits = json.loads((HERE / "limits" / "cave01_panorama.scene35.json").read_text())
        assert any(line["numbers"][k] > limits[k] for k in NEW), line


def seed_one(monkeypatch):
    draw = S.sample_hypotheses
    monkeypatch.setattr(S, "sample_hypotheses", lambda valid, k, seed=0: draw(valid, k, 1))


def test_another_ransac_draw_is_correct(root, monkeypatch):
    """RANSAC seed 1: other near-tied hypotheses win, as when a sound
    program's rounding reorders the lanes; they keep the inliers."""
    seed_one(monkeypatch)
    result, lines = run(root)
    assert result["correct"], lines


def inverted(monkeypatch):
    """Each edge's homography the wrong way round: parent -> frame."""
    ransac = S.ransac_homography

    def wrong_way(*a, **k):
        h, inl, n = ransac(*a, **k)
        return torch.linalg.inv(h), inl, n
    monkeypatch.setattr(S, "ransac_homography", wrong_way)


def few_hypotheses(monkeypatch):
    """Two hypotheses an edge in place of the configuration's 2048."""
    draw = S.sample_hypotheses
    monkeypatch.setattr(S, "sample_hypotheses", lambda valid, k, seed=0: draw(valid, 2, seed))


def no_gains(monkeypatch):
    monkeypatch.setattr(B, "estimate_gains", lambda images, *a, **k: np.ones(len(images)))


def bare_feather(monkeypatch):
    """The feather weight without its ``+ 1e-6``: zero on the borders."""
    warp = S.warp_accumulate

    def bare(image, h_inv, out_h, out_w):
        acc, wgt = warp(image, h_inv, out_h, out_w)
        bare_w = torch.where(wgt > 0, wgt - 1e-6, wgt)
        return acc / torch.clamp(wgt, min=1e-30)[..., None] * bare_w[..., None], bare_w
    monkeypatch.setattr(S, "warp_accumulate", bare)
    monkeypatch.setattr(B, "warp_accumulate", bare)


@pytest.mark.parametrize("fault", [inverted, few_hypotheses, no_gains, bare_feather],
                         ids=lambda f: f.__name__)
def test_a_planted_fault_fails_a_limit(root, monkeypatch, fault):
    fault(monkeypatch)
    result, lines = run(root)
    assert not result["correct"], lines


def read(name, run):
    return harness.load_module(HERE, "metrics", name).read(run)


SPANS = [
    ("request", 0.0, 1000.0),
    ("sift.sync.upload", 5.0, 2.0),  # detection, outside the stitching
    ("stitch", 100.0, 800.0),
    ("stitch.edges", 105.0, 60.0),
    ("geometry.sync.eigh", 110.0, 5.0),
    ("stitch.sync.homographies", 150.0, 10.0),
    ("stitch.blend", 400.0, 400.0),
    ("stitch.blend", 420.0, 100.0),  # the feather fallback inside multiband_blend
    ("sift.sync.table", 430.0, 1.0),
    ("stitch.sync.strip", 600.0, 20.0),
]
DEVICE = [("k", "kernel", 350.0, 100.0), ("k", "kernel", 700.0, 50.0),
          ("m", "gpu_memcpy", 760.0, 100.0)]


def run_of(spans=SPANS, traced=True, records=()):
    return harness.Run(None, list(records), 0.0, 1.0, [],
                       Trace(DEVICE, spans) if traced else None, dict(frames=35, requests=1))


def test_the_readers_read_a_synthetic_trace(monkeypatch):
    r = run_of()
    assert read("stitch.blend_ms_per_frame", r) == pytest.approx(400 / 1e3 / 35)
    # device busy inside [400, 800): 400-450, 700-750, 760-800
    assert read("stitch.blend_busy_pct", r) == pytest.approx(100 * 140 / 400)
    assert read("stitch.syncs_per_request", r) == 4
    monkeypatch.setattr(profiling, "_counts", {"blend.px_warped": 800, "blend.px_footprint": 100})
    assert read("blend.warp_fill_pct", r) == 12.5
    # the entry point's host time, from the client's spans of one frame each
    spans = [("entry", 0.0, 0.002, 1, 0), ("entry", 0.0, 0.004, 1, 0), ("entry", 0, 1, 1, 5)]
    pre = harness.Run(None, [dict(index=0, phase="pre")], 0.0, 1.0, spans, None, {})
    assert read("entry.host_ms_per_frame", pre) == pytest.approx(3.0)


@pytest.mark.parametrize("name", ["stitch.blend_ms_per_frame", "stitch.blend_busy_pct",
                                  "stitch.syncs_per_request", "blend.warp_fill_pct"])
def test_the_readers_read_nothing_without_a_trace_or_its_spans(monkeypatch, name):
    monkeypatch.setattr(profiling, "_counts", {})
    older = [s for s in SPANS if not s[0].startswith(("stitch.", "geometry."))]
    assert read(name, run_of(traced=False)) is None
    assert read(name, run_of(older)) is None
