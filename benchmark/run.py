"""The benchmark of ``sift_tpu_torch`` on the card: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed`` (requests),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` also ``breakdown``, and
last ``checks``: each number that decided ``correct`` beside its limit,
which also close standard error.  Exits 2 without a CUDA device (there is
no CPU fallback) and 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_MODULE = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from /proc where
    it is readable, else this module's import)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age if 0 <= age < 600 else T_MODULE
    except (OSError, ValueError, IndexError):
        return T_MODULE


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Build and kernel caches live at fixed places inside the checkout (the
    # program builds its kernels into sift_tpu_torch/_build/).
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    from benchmark import harness

    chips = harness.Cell(args.workload).cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     "cuda", t_start)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
