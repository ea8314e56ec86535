"""Kernel F's least time for the traced frames' octaves
(``benchmark/counts/kernel_F``) as a share of its device time in the
trace."""

from benchmark.counts import kernel_F


def read(run):
    if run.trace is None or not run.work.get("frames"):
        return None
    us = sum(e[3] for e in run.trace.kernels("octave_kernel<2>"))
    if not us:
        return None
    h, w = run.work["frame_shape"][:2]
    least = kernel_F.least(run.work["frames"], h, w, run.cell.config["sift"])
    return 100.0 * least / (us / 1e6)
