"""The share of the program's ``stitch.blend`` spans in which a kernel,
copy or memset ran on the card.  The blend starts after the edge
homographies' host read and ends with its canvas on the host, so the
device work inside it is the blend's."""

from benchmark.intervals import named, overlap


def read(run):
    iv = named(run, "stitch.blend")
    if iv is None:
        return None
    span = float((iv[:, 1] - iv[:, 0]).sum())
    return 100.0 * overlap(iv, run.trace.busy_intervals()) / span if span else None
