"""The 95th percentile of a streamed batch's time, from reading its files
to its matches on the host, over the requests of the traced run before its
profiler started."""

from benchmark.harness import p95


def read(run):
    return p95(run.latencies_ms("pre"))
