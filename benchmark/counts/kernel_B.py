"""Kernel B (``sift_tpu_torch/csrc/top2.cu``, ``top2_kernel``): the exact
top-2 of squared descriptor distances, one launch per matcher call.

Its work, per image pair of va query and vb target descriptors that are
valid (not the capacity's lanes): 2 * 128 * va * vb int8 operations (a
multiply and an add per byte pair), the valid descriptors read once (128
bytes each) and best, second and index written once per valid query row
(3 x 4 bytes)."""

from benchmark.counts import PEAKS, least_seconds


def work(va: int, vb: int) -> tuple[float, float]:
    return 128.0 * (va + vb) + 12.0 * va, 2.0 * 128 * va * vb


def least(pairs) -> float:
    """B's least seconds over ``pairs``, (va, vb) each."""
    nbytes = ops = 0.0
    for va, vb in pairs:
        b, o = work(va, vb)
        nbytes, ops = nbytes + b, ops + o
    return least_seconds(nbytes, ops, PEAKS["int8_ops_per_s"])
