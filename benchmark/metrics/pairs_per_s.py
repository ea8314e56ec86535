"""Image pairs matched by the requests that completed in the window, their
results on the host, per second of the window."""


def read(run):
    return sum(r["pairs"] for r in run.records if r["ok"]) / run.window_s
