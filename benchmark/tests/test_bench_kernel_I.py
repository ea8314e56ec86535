"""Kernel I's work counts and roofline reader: the counts worked by hand,
the window radii equal to the program's own on the reference's keypoints,
and the reader on a synthetic trace (the first requests' launches, the
lanes from the program's counters; nothing where the program launched no
kernel I or marked nothing)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.counts import PEAKS, kernel_I
from benchmark.reference import sift_plain
from benchmark.trace import Trace
from sift_tpu_torch.utils import profiling

torch.set_num_threads(2)
HERE = harness.ROOT / "benchmark"
CELL = "cave_vga.resident_b16"


def crop(frames):
    return [f[:96, :128].copy() for f in frames]


def test_kernel_i_counts_by_hand():
    """Radii 3 and 40 over 10 lanes: patches of 9^2 and 83^2 floats,
    7^2 + 81^2 samples of 59 operations, 153 bytes a lane."""
    nbytes, ops = kernel_I.work([3, 40], 10)
    assert nbytes == 4 * (81 + 83 * 83) + 153 * 10
    assert ops == 59 * (49 + 81 * 81)
    assert kernel_I.least([3, 40], 10) == pytest.approx(nbytes / PEAKS["hbm_bytes_per_s"])


def test_radii_are_the_program_s():
    """On the reference's keypoints of a crop, the counted radii equal the
    program's (``models/descriptor._lane_args``, clamped to its bound)."""
    from sift_tpu_torch import SiftConfig
    from sift_tpu_torch.models import descriptor as De
    from sift_tpu_torch.models import sift as S
    from sift_tpu_torch.ops.gather import StackSpace
    from sift_tpu_torch.utils.keypoints import Keypoints

    cell = harness.Cell(CELL)
    params = cell.config["sift"]
    frame = crop(harness.load_frames(cell.config))[0]
    kp = sift_plain.describe(torch.from_numpy(frame), params)
    n = len(kp["x"])
    assert n > 0
    got = kernel_I.radii(kp["size"].tolist(), kp["octave"].tolist(), *frame.shape[:2], params)
    cfg = SiftConfig(**{k: v for k, v in params.items() if k in SiftConfig.__dataclass_fields__})
    gaussians, _ = S.pyramids(S.as_batch(frame[None], cfg, "cpu"), cfg)
    prog = Keypoints.from_numpy({**{f: kp[f].numpy() for f in ("x", "y", "size", "pori",
                                                                  "octave", "layer", "desc")},
                                 "valid": np.ones(n, bool)}).map(lambda a: a[None])
    radius = De._lane_args(StackSpace.build(gaussians), prog, cfg, None)[1][De._RADIUS]
    want = radius.clamp_max(De.desc_radius_bound(cfg)).tolist()
    assert got == want
    assert max(got) > min(got)


def run_of(monkeypatch, launches_us, counts, n_traced=3, frames=8, trace=True):
    monkeypatch.setattr(harness, "load_frames", lambda config, root=None: crop(
        [np.load(harness.ROOT / config["frames"]["npz"].format(i))[config["frames"]["key"]]
         for i in config["frames"]["indices"][:4]]))
    monkeypatch.setattr(profiling, "_counts", counts)
    records = [dict(traced=k > 0, ok=True, frames=frames,
                    req=dict(frames=[k % 4] * frames, flip=k % 2)) for k in range(n_traced + 1)]
    device = [("describe_kernel", "kernel", 100.0 * k, us) for k, us in enumerate(launches_us)]
    device.append(("octave_kernel<2>", "kernel", 5.0, 7.0))
    return harness.Run(harness.Cell(CELL), records, 0.0, 1.0, [],
                       Trace(device, []) if trace else None, {})


def read(run):
    return harness.load_module(HERE, "metrics", "kernel_I.roofline_pct").read(run)


def test_reader_reads_the_first_requests_launches(monkeypatch):
    """Requests of 8 frames: the first two traced ones hold 16 frames, so
    the first two launches (30 + 50 us) against the reference's keypoints
    of frames 1 and 2 (flips 1 and 0), 8 times each, at 1000 lanes a
    launch (4000 lanes over 4 launches counted)."""
    run = run_of(monkeypatch, [30.0, 50.0, 70.0],
                 {"describe.kernel_lanes": 4000, "describe.kernel_launches": 4})
    cell = run.cell
    frames = harness.load_frames(cell.config)
    r = []
    for i, flip in ((1, 1), (2, 0)):
        kp = sift_plain.describe(torch.from_numpy(
            np.ascontiguousarray(frames[i][:, ::-1] if flip else frames[i])), cell.config["sift"])
        r += 8 * kernel_I.radii(kp["size"].tolist(), kp["octave"].tolist(), 96, 128,
                                cell.config["sift"])
    want = 100.0 * kernel_I.least(r, 2000) / 80e-6
    assert read(run) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_trace", "no_launches", "no_counters", "few_launches"])
def test_reader_reads_nothing_without_kernel_i(monkeypatch, case):
    counts = {} if case == "no_counters" else {"describe.kernel_lanes": 10,
                                               "describe.kernel_launches": 1}
    launches = {"no_launches": [], "few_launches": [30.0]}.get(case, [30.0, 50.0])
    run = run_of(monkeypatch, launches, counts, trace=case != "no_trace")
    assert read(run) is None
