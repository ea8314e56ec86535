"""The readers of the program's own spans and counters: host waits inside
the entry point per frame, their milliseconds, and the lane fill of the
orientation and descriptor contractions; nothing where the program marks
nothing (an older program) or the run has no trace."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny
from benchmark.trace import Trace
from sift_tpu_torch.utils import profiling

torch.set_num_threads(2)
HERE = harness.ROOT / "benchmark"
SPANS = [
    ("request", 0.0, 1000.0),
    ("sift.entry", 10.0, 490.0),
    ("sift.front_twin", 15.0, 100.0),
    ("sift.sync.table", 20.0, 10.0),
    ("sift.orient", 120.0, 200.0),
    ("sift.sync.lanes", 130.0, 40.0),
    ("sift.entry", 600.0, 300.0),
    ("sift.sync.classes", 610.0, 5.0),
    ("sift.match", 940.0, 30.0),
    ("sift.sync.table", 950.0, 10.0),  # in the matcher, not the entry point
]


def read(name, run):
    return harness.load_module(HERE, "metrics", name).read(run)


def run_of(spans, frames=4, traced=True):
    return harness.Run(None, [], 0.0, 1.0, [], Trace([], spans) if traced else None,
                       dict(frames=frames))


def test_syncs_inside_the_entry_point_per_frame():
    run = run_of(SPANS)
    assert read("entry.syncs_per_frame", run) == 3 / 4
    assert read("entry.sync_ms_per_frame", run) == pytest.approx((10 + 40 + 5) / 1e3 / 4)


@pytest.mark.parametrize("name", ["entry.syncs_per_frame", "entry.sync_ms_per_frame"])
def test_no_entry_spans_read_nothing(name):
    older = [s for s in SPANS if not s[0].startswith("sift.")] + [("entry", 10.0, 490.0)]
    assert read(name, run_of(older)) is None
    assert read(name, run_of(SPANS, traced=False)) is None
    assert read(name, run_of(SPANS, frames=0)) is None


@pytest.mark.parametrize("stage", ["orient", "describe"])
def test_lane_fill_reads_the_counters(monkeypatch, stage):
    name = f"{stage}.lane_fill_pct"
    monkeypatch.setattr(profiling, "_counts", {f"{stage}.samples_valid": 300,
                                               f"{stage}.samples_computed": 1200})
    assert read(name, run_of(SPANS)) == 25.0
    assert read(name, run_of(SPANS, traced=False)) is None
    monkeypatch.setattr(profiling, "_counts", {})
    assert read(name, run_of(SPANS)) is None


def test_a_traced_run_reports_the_program_metrics(tmp_path, monkeypatch):
    """The profiler from the window's first request, over one request."""
    monkeypatch.setattr(profiling, "_counts", {})
    monkeypatch.setattr(harness, "TRACE_LEAD", 0.0)
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.01)
    root = tiny.make(tmp_path)
    result, lines = harness.run_cell("tiny_demo_pair.cli_pair", 2**33 + 5, 3.0, True, "cpu",
                                     hooks=dict(root=root, frames=tiny.crop))
    assert result["correct"], lines
    m = result["metrics"]
    assert {"entry.syncs_per_frame", "entry.sync_ms_per_frame", "describe.lane_fill_pct",
            "orient.lane_fill_pct"} <= set(m)
    assert m["entry.syncs_per_frame"]["value"] > 0
    assert 0 < m["orient.lane_fill_pct"]["value"] <= 100
    assert 0 < m["describe.lane_fill_pct"]["value"] <= 100
