"""Host waits for the card per reconstruction: the program's
``sift.sync.*``, ``sfm.sync.*``, ``ba.sync.*``, ``geometry.sync.*`` and
``stitch.sync.*`` spans within the client's ``sfm`` spans (``run_sfm``,
one a request) in the traced run's profiler window, over those spans;
None where the program marks no ``sfm.run``."""

from benchmark.nested import inside

WAITS = ("sift.sync.", "sfm.sync.", "ba.sync.", "geometry.sync.", "stitch.sync.")


def read(run):
    if run.trace is None or not any(s[0] == "sfm.run" for s in run.trace.spans):
        return None
    syncs = [inside(run, "sfm", p) for p in WAITS]
    if syncs[0] is None:
        return None
    return sum(map(len, syncs)) / sum(1 for s in run.trace.spans if s[0] == "sfm")
