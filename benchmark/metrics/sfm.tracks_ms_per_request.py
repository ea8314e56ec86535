"""Milliseconds a request in the program's host-only SfM bookkeeping: the
union of its ``sfm.tracks`` spans (union-find tracks, their index, the
initial pair's tally, the registration's candidate picks and the bundle
adjustments' observation rows) in the traced run's profiler window, over
the traced requests; None where the program marks none."""

from benchmark.intervals import named


def read(run):
    iv = named(run, "sfm.tracks")
    if iv is None or not run.work.get("requests"):
        return None
    return float((iv[:, 1] - iv[:, 0]).sum()) / 1e3 / run.work["requests"]
