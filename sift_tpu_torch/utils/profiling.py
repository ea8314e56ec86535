"""Observability: per-stage timing, counters and device profiling.

Counterpart of ``sift_tpu/utils/profiling.py``.  The reference interleaves
std::cout progress logging with compute (src/sift.cpp:188-198,719-773).
Here observability is structured and opt-in: a ``StageTimer`` collects
wall times per named stage, each stage is a ``torch.profiler``
``record_function`` range in a trace, and ``trace_to(dir)`` captures a
trace that Perfetto (or chrome://tracing) opens.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from collections import defaultdict

import torch

from sift_tpu_torch.utils.debug import tree_leaves


class StageTimer:
    """Accumulates wall-clock per named stage; supports nested scopes.

    ``sync``: after the body, wait for the devices of ``result``'s tensors
    (the work PyTorch queued on a card), so that a stage's time is its
    work's and not its launches'.
    """

    def __init__(self, sync: bool = False):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        if self.sync and result is not None:
            for dev in {a.device for _, a in tree_leaves(result)
                        if isinstance(a, torch.Tensor) and a.is_cuda}:
                torch.cuda.synchronize(dev)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 6),
                "calls": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / self.counts[name], 3),
            }
            for name in sorted(self.totals)
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


def time_calls(fn, reps: int, calls: int = 8):
    """(median, min) seconds of one call of ``fn``, and its last result: one
    warm-up call, then ``reps`` rounds of ``calls`` calls in a row, each
    round closed by a wait for the card (where there is one) and divided by
    ``calls``.  The JAX package's tool scripts time the same way, with a
    host read of the last result as the fence."""
    def wait():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    out = fn()
    wait()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn()
        wait()
        ts.append((time.perf_counter() - t0) / calls)
    return statistics.median(ts), min(ts), out


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture a trace of the body (CPU, and the card's kernels where there
    is one) into ``log_dir/trace.json``, which Perfetto opens; yields the
    profiler (``key_averages()`` gives the sums by operator)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Metrics:
    """Structured pipeline metrics (counts per stage, fps) as one JSON doc --
    the structured replacement for the reference's stdout counters."""

    def __init__(self):
        self.values: dict = {}

    def set(self, key: str, value):
        self.values[key] = value

    def to_json(self) -> str:
        return json.dumps(self.values, sort_keys=True)
