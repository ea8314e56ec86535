"""Kernel B's least time for the traced pairs' valid descriptors
(``benchmark/counts/kernel_B``) as a share of its device time in the
trace."""

from benchmark.counts import kernel_B


def read(run):
    if run.trace is None or not run.work.get("pair_valid"):
        return None
    us = sum(e[3] for e in run.trace.kernels("top2_kernel"))
    if not us:
        return None
    return 100.0 * kernel_B.least(run.work["pair_valid"]) / (us / 1e6)
