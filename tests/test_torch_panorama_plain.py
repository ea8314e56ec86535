"""The stitching slice against the frozen plain reference
(``benchmark/reference/stitch_plain.py``, the yardstick of the
benchmark's ``cave01_panorama`` cells) in float32 on the CPU, and the
slice's spans and counters (``utils/profiling``).

CAVE-01 frames 00-04 (``tests/data/scene_oracle``), and frames 00-02
flipped left-right, go through the entry point one frame at a time at
``cave_vga``'s capacities, as the stitch command detects, and the
reference stitches the program's keypoints, so the comparison is the
stitching's alone.  The program's edge homographies must keep the
reference's RANSAC inliers within a tenth of the cell's limit and, on
the CPU, map a frame's corners within 0.005 px of the reference's; its
canvas must be the reference's canvas of those homographies within the
cell's pixel limit (``benchmark/limits/cave01_panorama.scene35.json``).
"""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.clients.panorama import Tally
from benchmark.reference import stitch_plain
from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.models import stitch as S
from sift_tpu_torch.models.sift import detect_and_describe_batch
from sift_tpu_torch.utils import numerics, profiling
from sift_tpu_torch.utils.keypoints import Keypoints
from sift_tpu_torch.utils.stitch_graph import chain_graph

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "cave01_panorama.json").read_text())
LIMITS = json.loads((ROOT / "benchmark" / "limits" / "cave01_panorama.scene35.json").read_text())
PARAMS = CONFIG["stitch"]
CFG = SiftConfig(**CONFIG["sift"])
CPU = torch.device("cpu")


def frame(i: int) -> np.ndarray:
    return np.load(ROOT / "tests" / "data" / "scene_oracle" / f"cave01_{i:02d}.npz")["input"]


SCENES = {"upright": lambda: [frame(i) for i in range(5)],
          "flipped": lambda: [np.ascontiguousarray(frame(i)[:, ::-1]) for i in range(3)]}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """(name, frames, the program's keypoints of each frame, one at a time)."""
    frames = SCENES[request.param]()
    kps = []
    for img in frames:
        kp = detect_and_describe_batch(img[None].astype(np.float32), CFG, device=CPU)
        kps.append(kp.map(lambda a: a[0]))
    return request.param, frames, kps


def plain_keypoints(kps):
    return [dict(x=kp.x[kp.valid], y=kp.y[kp.valid], desc=kp.desc[kp.valid]) for kp in kps]


def test_stitch_scene_is_the_plain_panorama(scene):
    _, frames, kps = scene
    graph = chain_graph(len(frames))
    imgs = [f.astype(np.float32) for f in frames]
    pano = S.stitch_scene(imgs, graph, CFG, num_hypotheses=PARAMS["num_hypotheses"], kps=kps,
                          device=CPU)
    plain = plain_keypoints(kps)
    m_ref = stitch_plain.edge_matches(plain, CFG.ori_cap, CFG.ratio_threshold, CPU)
    h_ref = stitch_plain.edge_homographies(plain, PARAMS, CFG.ori_cap, CFG.ratio_threshold, CPU,
                                           matches=m_ref)
    h_prog = S.solve_edge_homographies(kps, graph, CFG, PARAMS["num_hypotheses"])
    tally = Tally()
    tally.homographies(h_prog, h_ref, {e: (p1[c].numpy().astype(np.float64),
                                           p2[c].numpy().astype(np.float64))
                                       for e, (p1, p2, c) in m_ref.items()},
                       PARAMS["inlier_threshold"])
    pano_ref = stitch_plain.panorama(frames, h_prog, PARAMS, CPU)
    assert pano.shape == pano_ref.shape
    tally.canvas(pano, pano_ref)
    got = tally.numbers()
    assert tally.edges == len(frames) - 1
    assert got["homography_inliers_lost_pct"] <= LIMITS["homography_inliers_lost_pct"] / 10
    assert got["panorama_pixels_off_pct"] <= LIMITS["panorama_pixels_off_pct"]
    # on the CPU the program keeps the reference's RANSAC draws: its edge
    # homographies map a frame's corners within 0.005 px of the reference's
    h, w = frames[0].shape[:2]
    for e, h_r in h_ref.items():
        assert corner_px(h_prog[e], h_r, h, w) <= 0.005, e


def corner_px(h_a, h_b, h: int, w: int) -> float:
    """The largest distance between two homographies' images of an h x w
    frame's four corners."""
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64)
    a, b = c @ np.asarray(h_a, np.float64).T, c @ np.asarray(h_b, np.float64).T
    return float(np.hypot(*(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:]).T).max())


def test_the_feather_fallback_is_the_plain_feather(scene):
    """The cell's canvas is past ``max_multiband_pixels``: the feather
    average over strips, with gains."""
    _, frames, kps = scene
    h_edge = S.solve_edge_homographies(kps, chain_graph(len(frames)), CFG,
                                       PARAMS["num_hypotheses"])
    params = dict(PARAMS, max_multiband_pixels=0, strip_rows=256)
    hs = stitch_plain.centred(frames, h_edge)
    imgs = [f.astype(np.float32) for f in frames]
    out_h, out_w, t = S._canvas_layout(imgs, hs)
    from sift_tpu_torch.models.blend import estimate_gains

    gains = estimate_gains(imgs, [t @ h for h in hs], out_h, out_w, device=CPU)
    pano = S.blend_warped(imgs, hs, strip_rows=256, gains=gains, device=CPU)
    want = stitch_plain.panorama(frames, h_edge, params, CPU)
    assert pano.shape == want.shape
    assert np.array_equal(pano, want)


def toy_scene(n=3, h=20, w=30, step=(10, 2)):
    """``n`` images of (h, w) and their translations into the centre
    frame, ``step`` pixels (x, y) apart."""
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(0, 255, (h, w, 3)).astype(np.float32) for _ in range(n)]
    hs = [np.array([[1, 0, step[0] * k], [0, 1, step[1] * k], [0, 0, 1]], np.float64)
          for k in range(n)]
    return imgs, hs


def toy_keypoints(n_frames=3, lanes=16, valid=12, step=(10.0, 2.0)):
    """Keypoints whose descriptors repeat across frames at positions
    ``step`` apart: every edge's matches are the same lanes."""
    rng = np.random.default_rng(7)
    desc = rng.integers(0, 256, (lanes, 128)).astype(np.uint8)
    x, y = rng.uniform(0, 25, lanes).astype(np.float32), rng.uniform(0, 15, lanes).astype(np.float32)
    out = []
    for k in range(n_frames):
        v = np.arange(lanes) < valid
        out.append(Keypoints.from_numpy(dict(
            x=np.where(v, x - step[0] * k, 0), y=np.where(v, y - step[1] * k, 0),
            octave=np.zeros(lanes), layer=np.ones(lanes), size=np.ones(lanes, np.float32),
            pori=np.zeros(lanes, np.float32), desc=desc * v[:, None], valid=v)))
    return out


def profiled(fn):
    """(fn's result, the spans recorded, the counters added) under a torch
    profiler."""
    before = profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    after = profiling.counters()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith(("stitch.", "sift.sync.", "geometry.sync."))]
    return out, spans, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def within(spans, inner: str, outer: str) -> bool:
    """Every span ``inner`` lies inside some span ``outer``."""
    outs = [(a, b) for n, a, b in spans if n == outer]
    return all(any(a <= s and e <= b for a, b in outs) for n, s, e in spans if n == inner)


def test_spans_nest_as_the_stages_run():
    imgs, _ = toy_scene()
    kps = toy_keypoints()
    graph = chain_graph(3)
    _, spans, _ = profiled(lambda: S.stitch_scene(imgs, graph, CFG, num_hypotheses=64, kps=kps,
                                                  device=CPU))
    names = [n for n, _, _ in spans]
    assert names.count("stitch.scene") == 1
    assert names.count("stitch.edges") == 1 and names.count("stitch.ransac") == 2
    assert names.count("stitch.sync.homographies") == 1 and names.count("geometry.sync.eigh") == 2
    for inner, outer in [("stitch.edges", "stitch.scene"), ("stitch.ransac", "stitch.edges"),
                         ("geometry.sync.eigh", "stitch.ransac"),
                         ("stitch.sync.homographies", "stitch.edges"),
                         ("stitch.layout", "stitch.scene"), ("stitch.gains", "stitch.scene"),
                         ("stitch.sync.gains", "stitch.gains"), ("stitch.blend", "stitch.scene"),
                         ("stitch.sync.strip", "stitch.blend")]:
        assert inner in names and within(spans, inner, outer), (inner, outer)
    # the feather fallback: one host read a strip, and the warps' two xdiv
    # divisors built once each (a fresh cache), inside the blend
    numerics._built.cache_clear()
    _, spans, _ = profiled(lambda: S.blend_warped(imgs, toy_scene()[1], strip_rows=8,
                                                  device=CPU))
    names = [n for n, _, _ in spans]
    assert names.count("stitch.blend") == 1 and names.count("stitch.sync.strip") == 3
    assert names.count("sift.sync.table") == 2
    assert within(spans, "sift.sync.table", "stitch.blend")


def test_counters_count_the_toy_canvas():
    """Three 20 x 30 images 10 px apart in x and 2 in y: a 24 x 50 canvas,
    each image's footprint 20 x 30; strips of 8 rows sample 3 x 8 x 50
    pixels an image; the multiband pass warps each image twice over the
    canvas padded to 32 x 64."""
    imgs, hs = toy_scene()
    assert S._canvas_layout(imgs, hs)[:2] == (24, 50)
    _, _, c = profiled(lambda: S.blend_warped(imgs, hs, strip_rows=8, device=CPU))
    assert c == {"blend.px_warped": 3 * 3 * 8 * 50, "blend.px_footprint": 3 * 20 * 30}
    _, _, c = profiled(lambda: S.composite(imgs, hs, device=CPU))
    assert c == {"blend.px_warped": 3 * 2 * 32 * 64, "blend.px_footprint": 2 * 3 * 20 * 30}
    _, _, c = profiled(lambda: S.solve_edge_homographies(toy_keypoints(), chain_graph(3), CFG, 64))
    assert c == {"stitch.edges": 2, "stitch.hypothesis_lanes": 2 * 64 * 16}


def test_a_canvas_cut_by_its_clamp_counts_only_its_pixels():
    imgs, _ = toy_scene(n=2)
    hs = [np.eye(3), np.array([[1, 0, 100.0], [0, 1, 0], [0, 0, 1]])]
    _, _, c = profiled(lambda: S.blend_warped(imgs, hs, max_canvas=110, strip_rows=32,
                                              device=CPU))
    # canvas 20 x 110: the second image keeps 10 of its 30 columns
    assert c == {"blend.px_warped": 2 * 20 * 110, "blend.px_footprint": 20 * 30 + 20 * 10}


def test_the_reference_imports_neither_jax_nor_the_port():
    forbidden = ("jax", "jaxlib", "sift_tpu", "sift_tpu_torch")
    for name in ("stitch_plain", "sift_plain", "match_plain"):
        tree = ast.parse((ROOT / "benchmark" / "reference" / f"{name}.py").read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            assert not [m for m in mods if m.split(".")[0] in forbidden], (name, mods)
    code = ("import sys; import benchmark.reference.stitch_plain; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_sync_audit_takes_the_stitching_spans():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import torch_sync_audit as A
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    a = A.Audit()
    sync = "called a synchronizing CUDA operation"
    with a.span("stitch.scene"):
        with a.span("stitch.ransac"):
            with a.span("geometry.sync.eigh"):
                a.warned(sync, UserWarning, str(ROOT / "sift_tpu_torch/models/geometry.py"), 3)
        with a.span("stitch.blend"):
            with a.span("stitch.sync.strip"):
                a.warned(sync, UserWarning, str(ROOT / "sift_tpu_torch/models/stitch.py"), 1)
            a.warned(sync, UserWarning, str(ROOT / "sift_tpu_torch/models/stitch.py"), 2)
    assert a.sites == {
        "sift_tpu_torch/models/stitch.py:1": dict(warnings=1, span="stitch.sync.strip"),
        "sift_tpu_torch/models/stitch.py:2": dict(warnings=1, span="outside (stitch.blend)"),
        "sift_tpu_torch/models/geometry.py:3": dict(warnings=1, span="geometry.sync.eigh")}
    assert dict(a.stages) == {"stitch.blend": 2, "stitch.ransac": 1} and not a.outside
