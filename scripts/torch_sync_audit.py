"""Where the port's host waits for the card: one request of a benchmark
cell under ``torch.cuda.set_sync_debug_mode("warn")``, each synchronising
call placed in the program's spans.

For each ``--workload`` (default: every cell of ``BENCHMARK.json``) the
cell's client (``benchmark/clients/``) sets up its frames and runs one
warm-up request; then one request runs with sync debugging on and the
program's spans (``sift_tpu_torch.utils.profiling.span``) live without a
profiler: each span is pushed on a stack, so every warning is placed in
the spans open when it was raised.  Prints one JSON line per cell:

* ``sites``: per line that synchronised (file:line), its warnings and the
  innermost span around it (``outside`` where no ``sift.sync.*`` span was
  open);
* ``spans``: per ``sift.sync.*`` span (name, and file:line of its
  ``with``), how often it was entered and the warnings raised inside it;
* ``by_stage``: the main path's warnings per innermost stage span
  (``sift.describe``, ``sift.orient``, ...; a stage without one is left
  out);
* ``outside_main_path``: the warnings raised outside every ``sift.*``
  span (the benchmark's own reads of the answers), each with the line of
  the checkout that led to it (else the innermost functions);
* ``counters``: the program's ``profiling.count`` totals of the request;
* ``ok``: every warning inside a ``sift.*`` span lies inside a
  ``sift.sync.*`` span.

    python scripts/torch_sync_audit.py [--workload cave_vga.resident_b16 ...] [--seed 1]

Needs the card: sync debugging is CUDA's.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import traceback
import types
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from sift_tpu_torch.utils import profiling  # noqa: E402


def site(frame) -> str:
    return f"{os.path.relpath(frame.f_code.co_filename, ROOT)}:{frame.f_lineno}"


def site_of(summary) -> str:
    return f"{os.path.relpath(summary.filename, ROOT)}:{summary.lineno}"


class Audit:
    """Spans as a stack and warnings placed in it."""

    def __init__(self):
        self.stack: list[list] = []  # [name, site, warnings]
        self.entered = collections.Counter()
        self.inside = collections.Counter()
        self.sites: dict = {}
        self.outside: collections.Counter = collections.Counter()
        self.stages: collections.Counter = collections.Counter()
        audit = self

        class Span:
            def __init__(self, name):
                self.name = name

            def __enter__(self):
                entry = [self.name, site(sys._getframe(1)), 0]
                audit.stack.append(entry)
                audit.entered[tuple(entry[:2])] += 1

            def __exit__(self, *exc):
                name, where, n = audit.stack.pop()
                audit.inside[(name, where)] += n

        self.span = Span

    def warned(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        where = f"{os.path.relpath(filename, ROOT)}:{lineno}"
        names = [e[0] for e in self.stack]
        if not any(n.startswith("sift.") for n in names):
            stack = traceback.extract_stack()[:-1]
            mine = [f for f in stack if f.filename.startswith(ROOT) and f.filename != __file__]
            frm = site_of(mine[-1]) if mine else " < ".join(f.name for f in stack[::-1][:4])
            self.outside[f"{where} from {frm}"] += 1
            return
        stages = [n for n in names if n.startswith("sift.") and not n.startswith("sift.sync.")]
        self.stages[stages[-1]] += 1
        syncs = [e for e in self.stack if e[0].startswith("sift.sync.")]
        if syncs:
            syncs[-1][2] += 1
        rec = self.sites.setdefault(where, dict(warnings=0, span=None))
        rec["warnings"] += 1
        rec["span"] = syncs[-1][0] if syncs else f"outside ({names[-1]})"


def audit_cell(name: str, seed: int) -> dict:
    dev = torch.device("cuda")
    cell = harness.Cell(name)
    frames = harness.load_frames(cell.config)
    client = harness.load_module(cell.here, "clients", cell.mix["client"]).Client(
        cell, frames, dev, harness.Spans(False), 1.0)
    reqs = client.setup(harness.requests(cell, len(frames), seed))
    client.request(next(reqs))
    harness.sync(dev)
    a = Audit()
    before = profiling.counters()
    saved = profiling._autograd_profiler, torch.profiler.record_function
    profiling._autograd_profiler = types.SimpleNamespace(_is_profiler_enabled=True)
    torch.profiler.record_function = a.span
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = a.warned
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = client.request(next(reqs))
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        profiling._autograd_profiler, torch.profiler.record_function = saved
    after = profiling.counters()
    client.close()
    spans = [dict(span=n, at=w, entered=c, warnings=a.inside[(n, w)])
             for (n, w), c in sorted(a.entered.items()) if n.startswith("sift.sync.")]
    return dict(
        workload=name, seed=seed, frames=out["frames"], card=torch.cuda.get_device_name(dev),
        sites=dict(sorted(a.sites.items())), spans=spans, by_stage=dict(sorted(a.stages.items())),
        outside_main_path=dict(a.outside),
        counters={k: v - before.get(k, 0) for k, v in after.items()},
        ok=all(not r["span"].startswith("outside") for r in a.sites.values()),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python scripts/torch_sync_audit.py")
    ap.add_argument("--workload", nargs="*")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch_sync_audit: sync debugging needs a CUDA device")
    names = args.workload or [w["name"] for w in
                              harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
    ok = True
    for name in names:
        res = audit_cell(name, args.seed)
        ok &= res["ok"]
        print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
