"""The share of the canvas pixels the blend's warps sample that lie in the
bounding box of the image's warped corners: ``blend.px_footprint`` over
``blend.px_warped``, the program's counters
(``sift_tpu_torch.utils.profiling.counters``) over the traced run's
profiler window.  The feather fallback warps every image over every
strip of the canvas."""


def read(run):
    if run.trace is None:
        return None
    from sift_tpu_torch.utils import profiling

    c = profiling.counters() if hasattr(profiling, "counters") else {}
    if not c.get("blend.px_warped"):
        return None
    return 100.0 * c["blend.px_footprint"] / c["blend.px_warped"]
