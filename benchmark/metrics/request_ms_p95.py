"""The 95th percentile over every request of the window, from the moment
it is handed to the program until its matches are on the host."""

from benchmark.harness import p95


def read(run):
    return p95(run.latencies_ms())
