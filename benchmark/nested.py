"""The program's own spans in a traced run: ``sift_tpu_torch`` marks its
stages and the points where the host waits for the card as profiler
ranges (``utils/profiling.span``), which ``trace.read`` keeps in
``Trace.spans`` beside the harness's."""

from __future__ import annotations

import bisect


def inside(run, outer: str, prefix: str) -> list[tuple] | None:
    """The spans named ``prefix...`` that lie within a span ``outer``, as
    ``(name, ts_us, dur_us)``; None where the trace holds no ``outer`` span
    (no trace, or a program that marks none)."""
    if run.trace is None:
        return None
    outers = sorted((t, t + d) for n, t, d in run.trace.spans if n == outer)
    if not outers:
        return None
    starts = [a for a, _ in outers]
    out = []
    for s in run.trace.spans:
        name, t, d = s
        if not name.startswith(prefix):
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t + d <= outers[k][1]:
            out.append(s)
    return out
