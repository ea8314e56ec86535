"""Milliseconds a request in the program's per-pair geometric verification
(``models/sfm._geometric_verify``: a homography and an essential-matrix
RANSAC a pair, and their host reads): the union of its ``sfm.verify``
spans in the traced run's profiler window, over the traced requests; None
where the program marks none."""

from benchmark.intervals import named


def read(run):
    iv = named(run, "sfm.verify")
    if iv is None or not run.work.get("requests"):
        return None
    return float((iv[:, 1] - iv[:, 0]).sum()) / 1e3 / run.work["requests"]
