"""Observability: spans, counters, per-stage timing and device profiling.

Counterpart of ``sift_tpu/utils/profiling.py``.  The reference interleaves
std::cout progress logging with compute (src/sift.cpp:188-198,719-773).
Here observability is structured and opt-in, and ``torch.profiler`` is
its one store and exporter:

* ``span(name)`` marks a range of host time as a ``record_function`` event
  while a profiler records, so the program's stages and host waits sit in
  the same trace, on the same clock, as the card's kernels and copies;
* ``count(name, n)`` adds to a total while a profiler records, and
  ``counters()`` reads the totals;
* ``StageTimer`` collects wall times per named stage, each stage a span;
* ``trace_to(dir)`` captures a trace that Perfetto (or chrome://tracing)
  opens.

With no profiler recording, ``span`` and ``count`` read one flag and do
nothing else.  The program's spans are ``sift.<stage>`` around each stage
function and ``sift.sync.<kind>`` around each point where the host waits
for the card (``upload``, ``table``, ``lanes``, ``classes``); the stitching
slice's are ``stitch.<stage>`` and ``stitch.sync.<kind>`` (``models/stitch``,
``models/blend``), and the shared solver's ``geometry.sync.eigh``
(``models/geometry``).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from collections import defaultdict

import torch

# The profiler's own flag, read as a module attribute on every call: it is
# True only while a profiler records (not in a schedule's warm-up step).
_autograd_profiler = torch.autograd.profiler
_NULL = contextlib.nullcontext()
_counts: dict[str, int] = {}


def span(name: str):
    """A ``record_function`` range named ``name`` while a torch profiler
    records; else a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)


def recording() -> bool:
    """Whether a torch profiler records: what ``span`` and ``count`` read,
    for a count whose operand costs host work to compute."""
    return _autograd_profiler._is_profiler_enabled


def count(name: str, n: int) -> None:
    """Add ``n`` to the total ``name`` while a torch profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of the totals that ``count`` accumulated while recording."""
    return dict(_counts)


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
        with span(name):
            yield
        if self.sync and result is not None:
            # here, not at the top: utils.debug imports ops.gather, which
            # imports this module
            from sift_tpu_torch.utils.debug import tree_leaves

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

