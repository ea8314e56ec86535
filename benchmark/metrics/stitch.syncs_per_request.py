"""Host waits for the card per panorama: the program's ``sift.sync.*``,
``stitch.sync.*`` and ``geometry.sync.*`` spans within the client's
``stitch`` spans (``solve_edge_homographies`` and ``compose_scene``, one a
request) in the traced run's profiler window, over those spans; None
where the program marks no ``stitch.edges``."""

from benchmark.nested import inside

WAITS = ("sift.sync.", "stitch.sync.", "geometry.sync.")


def read(run):
    if run.trace is None or not any(s[0] == "stitch.edges" for s in run.trace.spans):
        return None
    syncs = [inside(run, "stitch", p) for p in WAITS]
    if syncs[0] is None:
        return None
    return sum(map(len, syncs)) / sum(1 for s in run.trace.spans if s[0] == "stitch")
