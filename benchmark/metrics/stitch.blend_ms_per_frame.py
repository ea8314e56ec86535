"""Milliseconds per frame inside the program's ``stitch.blend`` spans
(``blend_warped`` and ``multiband_blend``, nested ones counted once) in
the traced run's profiler window, over the traced requests' frames."""

from benchmark.intervals import named


def read(run):
    iv = named(run, "stitch.blend")
    if iv is None or not run.work.get("frames"):
        return None
    return float((iv[:, 1] - iv[:, 0]).sum()) / 1e3 / run.work["frames"]
