"""Host milliseconds per frame spent waiting for the card inside the entry
point: the summed length of the program's ``sift.sync.*`` spans within
its ``sift.entry`` spans in the traced run's profiler window, over the
traced requests' frames."""

from benchmark.nested import inside


def read(run):
    syncs = inside(run, "sift.entry", "sift.sync.")
    if syncs is None or not run.work.get("frames"):
        return None
    return sum(d for _, _, d in syncs) / 1e3 / run.work["frames"]
