"""Host milliseconds per image pair inside ``match_descriptors`` and the
copy of its results to the host, over the requests of the traced run
before its profiler started."""


def read(run):
    spans = run.untraced("match")
    pairs = sum(s[3] for s in spans)
    return 1e3 * sum(s[2] - s[1] for s in spans) / pairs if pairs else None
