"""The device trace of a traced run: ``torch.profiler`` (CPU and CUDA
activities) over whole requests, exported as a Chrome trace into the
temporary directory, read back and deleted.

Device time is the union of the intervals of every kernel, copy and
memset; the traced window runs from the start of the first traced
request's span to the end of the last one's, both on the trace's clock.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from pathlib import Path

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROGRAM_CSRC = Path(__file__).resolve().parents[1] / "sift_tpu_torch" / "csrc"


def program_kernel_names() -> set[str]:
    """The names of the program's hand-written kernels: every
    ``__global__`` function of ``sift_tpu_torch/csrc/*.cu``."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    return {m for p in PROGRAM_CSRC.glob("*.cu") for m in pat.findall(p.read_text())}


class Trace:
    def __init__(self, device: list[tuple], spans: list[tuple]):
        self.device = device  # (name, cat, ts_us, dur_us)
        self.spans = spans  # (name, ts_us, dur_us)
        req = [(t, t + d) for n, t, d in spans if n == "request"]
        self.window = (min(a for a, _ in req), max(b for _, b in req)) if req else None

    def kernels(self, pattern: str | None = None) -> list[tuple]:
        return [e for e in self.device if e[1] == "kernel"
                and (pattern is None or pattern in e[0])]

    def busy_intervals(self) -> np.ndarray:
        """Merged device intervals inside the window, (n, 2) in us."""
        if self.window is None or not self.device:
            return np.zeros((0, 2))
        lo, hi = self.window
        iv = sorted((max(t, lo), min(t + d, hi)) for _, _, t, d in self.device
                    if t + d > lo and t < hi)
        merged: list[list[float]] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return np.asarray(merged, dtype=np.float64).reshape(-1, 2)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6 if self.window else 0.0

    @property
    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        between device intervals by the innermost span the host was in."""
        ops: dict[str, float] = {}
        for name, _, _, d in self.device:
            ops[name] = ops.get(name, 0.0) + d / 1e6
        iv = self.busy_intervals()
        gaps: dict[str, float] = {}
        if len(iv):
            lo, hi = self.window
            edges = np.concatenate([[lo], iv.ravel(), [hi]]).reshape(-1, 2)
            st = np.asarray([t for _, t, _ in self.spans])
            en = np.asarray([t + d for _, t, d in self.spans])
            du = en - st
            for a, b in edges:
                if b <= a:
                    continue
                m = 0.5 * (a + b)
                inside = np.nonzero((st <= m) & (en >= m))[0]
                name = self.spans[inside[np.argmin(du[inside])]][0] if len(inside) else "harness"
                gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
        def best(d):
            return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return dict(device_ops=best(ops), idle_gaps=best(gaps))


def read(prof) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="sift_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((e["name"], cat, float(e["ts"]), float(e["dur"])))
        elif cat == "user_annotation" and not e["name"].startswith("ProfilerStep"):
            spans.append((e["name"], float(e["ts"]), float(e["dur"])))
    return Trace(device, spans)
