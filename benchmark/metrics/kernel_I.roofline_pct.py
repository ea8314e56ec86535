"""Kernel I's least time (``benchmark/counts/kernel_I``) for the first
traced requests, until they hold ``FRAMES`` frames, as a share of those
requests' launches of ``describe_kernel`` in the trace (one a request, in
order).  Their keypoints are the plain reference's of the requests' frames
(the program's are gone when the readers run; the two differ by a few in
ten thousand); the lanes of a launch are the program's counters
``describe.kernel_lanes`` over ``describe.kernel_launches``."""

import torch

from benchmark import traffic
from benchmark.counts import kernel_I
from benchmark.reference import sift_plain

FRAMES = 16


def read(run):
    if run.trace is None:
        return None
    launches = sorted(run.trace.kernels("describe_kernel"), key=lambda e: e[2])
    from sift_tpu_torch.utils import profiling

    c = profiling.counters() if hasattr(profiling, "counters") else {}
    if not launches or not c.get("describe.kernel_launches"):
        return None
    lanes = c["describe.kernel_lanes"] // c["describe.kernel_launches"]
    reqs = []
    for r in run.records:
        if r["traced"]:
            reqs.append(r)
            if sum(q["frames"] for q in reqs) >= FRAMES:
                break
    if not reqs or len(launches) < len(reqs) or not all(r["ok"] for r in reqs):
        return None
    from benchmark.harness import load_frames

    frames = load_frames(run.cell.config, run.cell.root)
    params = run.cell.config["sift"]
    h, w = frames[0].shape[:2]
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    radii: list[int] = []
    keys = [(i, r["req"]["flip"]) for r in reqs for i in r["req"]["frames"]]
    per_key = {}
    for key in keys:
        if key not in per_key:
            img = torch.from_numpy(traffic.flipped(frames[key[0]], key[1])).to(dev)
            kp = sift_plain.describe(img, params)
            per_key[key] = kernel_I.radii(kp["size"].tolist(), kp["octave"].tolist(), h, w,
                                          params)
        radii += per_key[key]
    us = sum(e[3] for e in launches[:len(reqs)])
    return 100.0 * kernel_I.least(radii, lanes * len(reqs)) / (us / 1e6)
