"""Lengths of unions of spans in a traced run, in microseconds of the
profiler's clock."""

from __future__ import annotations

import numpy as np


def union(spans) -> np.ndarray:
    """The (n, 2) merged intervals [start, end) of ``(name, ts, dur)``
    spans."""
    merged: list[list[float]] = []
    for a, b in sorted((t, t + d) for _, t, d in spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return np.asarray(merged, dtype=np.float64).reshape(-1, 2)


def overlap(a: np.ndarray, b: np.ndarray) -> float:
    """The length of the intersection of two sets of merged intervals."""
    total, j = 0.0, 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            total += min(hi, b[k][1]) - max(lo, b[k][0])
            k += 1
    return total


def named(run, name: str) -> np.ndarray | None:
    """The union of the trace's spans ``name``; None without a trace or
    without such spans (a program that marks none)."""
    if run.trace is None:
        return None
    iv = union(s for s in run.trace.spans if s[0] == name)
    return iv if len(iv) else None
