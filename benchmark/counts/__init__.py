"""The work of a kernel, counted from what it computes (not from how the
kernel lays it out), and its least time at the card's published peaks
(``benchmark/peaks.json``).  One module per kernel."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def least_seconds(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The larger of the bytes at peak bandwidth and the operations at
    ``ops_per_s``."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / ops_per_s)
