"""Frames of the requests that completed in the window (detected,
described and matched, their matches on the host), per second of the
window."""


def read(run):
    return sum(r["frames"] for r in run.records if r["ok"]) / run.window_s
