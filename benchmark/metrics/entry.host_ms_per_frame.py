"""Host milliseconds inside the entry point ``detect_and_describe_batch``
per frame (the call returns after its own host reads), over the requests
of the traced run before its profiler started."""


def read(run):
    spans = run.untraced("entry")
    frames = sum(s[3] for s in spans)
    return 1e3 * sum(s[2] - s[1] for s in spans) / frames if frames else None
