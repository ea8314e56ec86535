"""The port's spans and counters (``utils/profiling.span`` / ``count``):
nothing but a flag read with no profiler recording; under
``torch.profiler`` the entry point's stage spans nest in ``sift.entry``
with the host waits (``sift.sync.*``) inside their stages; the lane-fill
counters of orientation and descriptors equal a recount from the class
counts and chunk sizes; ``StageTimer``'s stages are spans; the sync
audit (``scripts/torch_sync_audit.py``) places each warning in the spans
open when it was raised."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.models import descriptor as De
from sift_tpu_torch.models import orient as O
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.ops.gather import StackSpace
from sift_tpu_torch.utils import profiling

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
CAPS = dict(extrema_cap=1024, kp_cap=256, ori_cap=512)


def frames():
    img = np.load(DATA / "oracle_small.npz")["input"]
    return np.stack([img, img[:, ::-1]])


def no_record_function(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)


def user_spans(prof, tmp_path) -> list[tuple[str, float, float]]:
    """(name, start, end) of the trace's ``user_annotation`` events, in us."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_with_no_profiler_spans_and_counts_do_nothing(monkeypatch):
    no_record_function(monkeypatch)
    monkeypatch.setattr(profiling, "_counts", {})
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("sift.entry"):
        profiling.count("orient.samples_valid", 5)
    cfg = SiftConfig(**CAPS)
    kp = S.detect_and_describe_batch(frames(), cfg, device="cpu")
    assert int(kp.valid.sum()) > 0
    assert profiling.counters() == {}


@pytest.mark.parametrize("route, stage1", [("stacks", "sift.pyramids"),
                                           ("front_twin", "sift.front_twin")])
def test_entry_spans_nest_under_the_profiler(tmp_path, route, stage1):
    cfg = SiftConfig(**CAPS, use_octave_kernel=route == "front_twin")
    assert S.route_of(cfg, "cpu") == route
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        S.detect_and_describe_batch(frames(), cfg, device="cpu")
    spans = [s for s in user_spans(prof, tmp_path) if s[0].startswith("sift.")]
    entry = [s for s in spans if s[0] == "sift.entry"]
    assert len(entry) == 1
    stages = [s for s in spans if s[0] != "sift.entry" and not s[0].startswith("sift.sync.")]
    assert [s[0] for s in sorted(stages, key=lambda s: s[1])] == [
        stage1, "sift.detect_refine", "sift.orient", "sift.dedup", "sift.describe"]
    assert all(within(s, entry[0]) for s in spans)
    # properly nested: any two spans are disjoint or one holds the other
    for a in spans:
        for b in spans:
            assert a[2] <= b[1] or b[2] <= a[1] or within(a, b) or within(b, a)
    syncs = [s for s in spans if s[0].startswith("sift.sync.")]
    for stage in ("sift.orient", "sift.describe"):
        st = next(s for s in stages if s[0] == stage)
        inside = {s[0] for s in syncs if within(s, st)}
        assert {"sift.sync.lanes", "sift.sync.classes"} <= inside


def test_lane_fill_counters_equal_a_recount(monkeypatch):
    """``by_radius_class`` counts, per class of radius r with c valid lanes
    padded to n_pad, c (2r+1)^2 valid and n_pad (2r+1)^2 computed window
    samples; recounted from the stages' class counts and chunk sizes (256
    lanes in orientation and 64 in descriptors on the CPU, more to a smaller
    window)."""
    cfg = SiftConfig(**CAPS)
    imgs = S.as_batch(frames(), cfg, "cpu")
    gaussians, dogs = S.pyramids(imgs, cfg)
    kp, _ = S._detect_refine_fused(dogs, cfg, False)
    gsp = StackSpace.build(gaussians)
    monkeypatch.setattr(profiling, "_counts", {})
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cand, _ = S.orient(gsp, kp, cfg)
        allkp = S.dedup(cand, cfg)
        S.describe(gsp, allkp, cfg)
    got = profiling.counters()

    def recount(radii, counts, chunk):
        side = 2 * radii[-1] + 1
        valid = computed = 0
        for r, c in zip(radii, counts):
            lanes = chunk * max(1, side * side // (2 * r + 1) ** 2)
            valid += c * (2 * r + 1) ** 2
            computed += -(-c // lanes) * lanes * (2 * r + 1) ** 2
        return valid, computed

    want = {}
    for stage, mod, lanes_kp, chunk, radii in (
            ("orient", O, kp, 256, O.ori_radius_classes(cfg)),
            ("describe", De, allkp, 64, De.desc_radius_classes(cfg))):
        valid, computed = recount(radii, mod.class_counts(gsp, lanes_kp, cfg), chunk)
        assert 0 < valid <= computed
        want[f"{stage}.samples_valid"], want[f"{stage}.samples_computed"] = valid, computed
    assert got == want


def test_stage_timer_stages_are_spans(monkeypatch, tmp_path):
    names = []
    real = profiling.span

    def spy(name):
        names.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "span", spy)
    t = profiling.StageTimer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.stage("blur"):
            torch.ones(8) * 2
    assert names == ["blur"]
    assert [s[0] for s in user_spans(prof, tmp_path)] == ["blur"]
    no_record_function(monkeypatch)
    with t.stage("blur"):
        pass
    assert t.summary()["blur"]["calls"] == 2


def test_sync_spans_keep_the_stage_results():
    """The same keypoints with the spans recording as without."""
    cfg = dataclasses.replace(SiftConfig(**CAPS), use_octave_kernel=True)
    plain = S.detect_and_describe_batch(frames(), cfg, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = S.detect_and_describe_batch(frames(), cfg, device="cpu")
    for f in ("x", "y", "size", "pori", "desc", "valid"):
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f


def test_sync_audit_places_warnings_in_the_open_spans():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import torch_sync_audit as A
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    a = A.Audit()
    sync = "called a synchronizing CUDA operation"

    def warn(path, line):
        a.warned(sync, UserWarning, str(ROOT / path), line)

    warn("benchmark/clients/__init__.py", 37)
    with a.span("sift.entry"):
        with a.span("sift.orient"):
            with a.span("sift.sync.lanes"):
                warn("sift_tpu_torch/models/orient.py", 104)
            warn("sift_tpu_torch/models/orient.py", 150)
        a.warned("an unrelated warning", UserWarning, str(ROOT / "x.py"), 1)
    assert a.sites == {
        "sift_tpu_torch/models/orient.py:104": dict(warnings=1, span="sift.sync.lanes"),
        "sift_tpu_torch/models/orient.py:150": dict(warnings=1, span="outside (sift.orient)")}
    assert [k.split(" from ")[0] for k in a.outside] == ["benchmark/clients/__init__.py:37"]
    (where,) = [w for n, w in a.entered if n == "sift.sync.lanes"]
    assert a.inside[("sift.sync.lanes", where)] == 1
    assert where.startswith("tests/test_torch_tracing.py:")
