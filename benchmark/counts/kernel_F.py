"""Kernel F (``sift_tpu_torch/csrc/octave_front.cu``, ``octave_kernel<2>``):
one octave of the front-twin route, per launch a batch's octave.

Its work, per octave of h x w pixels and n = intervals + 2 blurs: the
seed plane read once; the gauss layers later stages read (1 ..
intervals) and the n DoG planes written once as dense float32 planes, the
n - 2 extremum masks at a byte a pixel (a 0/1 flag, whatever width the
kernel stores it in), the masks' 128-lane popcounts as int32, and the next
octave's seed (h/2 x w/2).  No padding, no twin duplicates, no zero lanes.
float32 operations per pixel: each separable blur 2 * (2 + 3 * (taps - 1))
(a multiply, taps - 1 times add-multiply-add, a divide, per pass), one
subtraction per DoG, and 26 max + 26 min + abs + compare (55) per mask
layer.  The octaves of frames wider than ``FALLBACK_WIDTH`` columns take
the program's fallback (kernels A and G), not F."""

import math

from benchmark.counts import PEAKS, least_seconds
from benchmark.reference.sift_plain import DEFAULTS, gaussian_kernels, half_kernel

FALLBACK_WIDTH = 19328


def octaves(h: int, w: int, params: dict) -> list[tuple[int, int]]:
    p = {**DEFAULTS, **params}
    if p["double_image_size"]:
        h, w = 2 * h, 2 * w
    out = []
    for _ in range(int(math.floor(math.log2(min(h, w) // 3)))):
        out.append((h, w))
        h, w = h // 2, w // 2
    return out


def work(h: int, w: int, params: dict) -> tuple[float, float]:
    """(bytes, float32 operations) of F over one (h, w) frame's octaves."""
    p = {**DEFAULTS, **params}
    taps = [len(half_kernel(s)) for s in gaussian_kernels(p)[1:]]
    n = len(taps)
    ops_px = sum(2 * (2 + 3 * (t - 1)) + 1 for t in taps) + (n - 2) * 55
    nbytes = ops = 0.0
    for ho, wo in octaves(h, w, p):
        if wo > FALLBACK_WIDTH:
            continue
        px = ho * wo
        nbytes += 4 * px * (1 + p["intervals"] + n) + px * (n - 2)
        nbytes += 4 * (n - 2) * ho * -(-wo // 128) + 4 * (ho // 2) * (wo // 2)
        ops += px * ops_px
    return nbytes, ops


def least(frames: int, h: int, w: int, params: dict) -> float:
    """F's least seconds for ``frames`` frames of (h, w)."""
    nbytes, ops = work(h, w, params)
    return least_seconds(frames * nbytes, frames * ops, PEAKS["f32_ops_per_s"])
