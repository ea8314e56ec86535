"""Host waits for the card per frame inside the entry point: the
program's ``sift.sync.*`` spans within its ``sift.entry`` spans in the
traced run's profiler window, over the traced requests' frames."""

from benchmark.nested import inside


def read(run):
    syncs = inside(run, "sift.entry", "sift.sync.")
    if syncs is None or not run.work.get("frames"):
        return None
    return len(syncs) / run.work["frames"]
