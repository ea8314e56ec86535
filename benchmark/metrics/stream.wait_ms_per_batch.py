"""Milliseconds the main thread waits in ``next()`` on the staged batches
(``ImageLoader`` decoding, ``stage_batches`` converting and copying) per
batch, over the requests of the traced run before its profiler started."""


def read(run):
    spans = run.untraced("loader.next")
    return 1e3 * sum(s[2] - s[1] for s in spans) / len(spans) if spans else None
