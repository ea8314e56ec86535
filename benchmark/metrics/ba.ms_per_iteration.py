"""Milliseconds a Levenberg-Marquardt iteration of the program's bundle
adjustment: the union of its ``sfm.ba`` spans (each ``ba_solve``) in the
traced run's profiler window over its ``ba.iterations`` counter
(``sift_tpu_torch.utils.profiling.counters``) in that window; None where
the program marks or counts none."""

from benchmark.intervals import named


def read(run):
    iv = named(run, "sfm.ba")
    if iv is None:
        return None
    from sift_tpu_torch.utils import profiling

    c = profiling.counters() if hasattr(profiling, "counters") else {}
    if not c.get("ba.iterations"):
        return None
    return float((iv[:, 1] - iv[:, 0]).sum()) / 1e3 / c["ba.iterations"]
