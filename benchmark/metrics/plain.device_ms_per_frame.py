"""Device milliseconds per frame of every kernel that is not one of the
program's own (``sift_tpu_torch/csrc/*.cu``): the plain-PyTorch stages 2-5
and their glue, from the profiler's trace."""

import re

from benchmark.trace import program_kernel_names


def read(run):
    if run.trace is None or not run.work.get("frames"):
        return None
    own = re.compile(r"\b(" + "|".join(sorted(program_kernel_names())) + r")\b")
    us = sum(d for name, _, _, d in run.trace.kernels() if not own.search(name))
    return us / 1e3 / run.work["frames"]
