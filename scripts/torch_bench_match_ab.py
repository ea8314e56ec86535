"""The matcher across descriptor-set sizes on the card: the counterpart of
``scripts/bench_match_ab.py`` for the port (sift_tpu_torch).

N x 128 uint8 descriptors a side (values in [0, 180), all valid), drawn
from ``np.random.default_rng(0)`` in the JAX script's order, go through
three paths at each size:

* ``kernel``: ``models/match.match_descriptors``, whose top-2 is kernel B
  (``csrc/top2.cu``) on the card: a running top-2 per row, the N x M
  distances never stored;
* ``plain``: ``ops/top2.top2_plain`` + ``ratio_accept``, kernel B's plain
  version, which forms the N x M distances (the JAX script's XLA path);
* ``library``: ``torch.cdist`` + ``topk`` in float32 with TF32 off, the
  yardstick ``chip_smoke.py`` holds kernel B to; nothing in the port calls
  it.

One JSON line per (size, path): ``n``, ``path``, ``median_ms``,
``min_ms`` (one call, over ``--reps`` rounds of 8 calls closed by a wait
for the card) and ``tflops_at_min`` (2 N M 128 operations over the
minimum), the kernel's with its launches.  A ``plain`` or ``library``
path that runs out of the card's memory is a line with its ``error``; any
other failure, and every failure of the kernel path, ends the run
non-zero.  Then a line per size with kernel B's bound (``chip_smoke.py``'s
``top2_bound``: the multiply-adds at the card's int8 rate, each input read
once), and the agreement: ``idx``, ``accept``, ``best`` and ``second`` of
``kernel`` bit-equal to ``plain`` at 4096 (as the JAX script checks) and
at every size where ``plain`` ran; a disagreement exits 1.

    python scripts/torch_bench_match_ab.py [--reps 20]
        [--sizes 2048 8192 16384 32768] [--device cpu]

Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from sift_tpu_torch.models.match import match_descriptors, ratio_accept  # noqa: E402
from sift_tpu_torch.ops.top2 import top2, top2_plain  # noqa: E402
from sift_tpu_torch.utils.numerics import resolve_device  # noqa: E402
from sift_tpu_torch.utils.profiling import time_calls  # noqa: E402

RATIO = 0.75
AGREEMENT_N = 4096


def draws(sizes, seed=0):
    """(n, desc1, desc2) as the JAX script draws them: two (n, 128) uint8
    sets per size in ``sizes``' order, then two at ``AGREEMENT_N``."""
    rng = np.random.default_rng(seed)
    for n in [*sizes, AGREEMENT_N]:
        d1 = rng.integers(0, 180, (n, 128), dtype=np.uint8)
        d2 = rng.integers(0, 180, (n, 128), dtype=np.uint8)
        yield n, d1, d2


def paths(d1, d2, dev):
    """The three paths on one size's descriptors, on ``dev``: name ->
    function; ``kernel`` and ``plain`` return (idx, accept, best, second)."""
    a, b = (torch.from_numpy(d).to(dev) for d in (d1, d2))
    v1 = torch.ones(a.shape[0], dtype=torch.bool, device=dev)
    v2 = torch.ones(b.shape[0], dtype=torch.bool, device=dev)
    fa, fb = a.float(), b.float()

    def kernel():
        return match_descriptors(a, v1, b, v2, RATIO, device=dev)

    def plain():
        best, second, idx = top2_plain(a[None], b[None], v2[None])
        return idx[0], ratio_accept(best, second, v1[None], RATIO)[0], best[0], second[0]

    def library():
        return torch.cdist(fa, fb).topk(2, dim=-1, largest=False)

    return dict(kernel=kernel, plain=plain, library=library)


def agree(got, ref) -> bool:
    return all(torch.equal(x, y) for x, y in zip(got, ref))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sizes", type=int, nargs="*", default=[2048, 8192, 16384, 32768])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    print(json.dumps(dict(device=dev.type, name=torch.cuda.get_device_name(dev) if cuda else "cpu",
                          nvidia_smi=C.smi_line() if cuda else None, sizes=args.sizes,
                          reps=args.reps, torch=torch.__version__,
                          tf32=torch.backends.cuda.matmul.allow_tf32)), flush=True)
    agreement = {}
    for n, d1, d2 in draws(args.sizes):
        fns = paths(d1, d2, dev)
        if n == AGREEMENT_N:  # the JAX script's check, after the timed sizes
            agreement[n] = agree(fns["kernel"](), fns["plain"]())
            break
        ops = 2.0 * n * n * 128
        ran_plain = False
        for name, fn in fns.items():
            before = top2.launches
            try:
                med, mn, _ = time_calls(fn, args.reps)
            except torch.cuda.OutOfMemoryError as e:
                if name == "kernel":
                    raise
                print(json.dumps(dict(n=n, path=name, error=f"OutOfMemoryError: {str(e)[:200]}")),
                      flush=True)
                torch.cuda.empty_cache()
                continue
            row = dict(n=n, path=name, median_ms=med * 1e3, min_ms=mn * 1e3,
                       tflops_at_min=ops / mn / 1e12)
            if name == "kernel":
                row["launches"] = top2.launches - before
            ran_plain |= name == "plain"
            print(json.dumps(row), flush=True)
        if ran_plain:
            agreement[n] = agree(fns["kernel"](), fns["plain"]())
        del fns
        if cuda:
            torch.cuda.empty_cache()
        bytes_ms, ops_ms = C.top2_bound(1, n, n)
        b_ms, b_by = C.bound(bytes_ms, ops_ms)
        print(json.dumps(dict(n=n, bound_ms=b_ms, bound_by=b_by, bytes_ms=bytes_ms,
                              ops_ms=ops_ms)), flush=True)
    print(json.dumps(dict(agreement={str(n): ok for n, ok in agreement.items()},
                          agreement_4096=agreement[AGREEMENT_N])), flush=True)
    return 0 if all(agreement.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
