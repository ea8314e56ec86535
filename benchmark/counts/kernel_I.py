"""Kernel I (``sift_tpu_torch/csrc/describe.cu``, ``describe_kernel``): the
descriptor stage, one launch per request over its batch's post-dedup
keypoint buffer, valid lanes and capacity lanes alike.

Its work, per valid keypoint of window radius r (src/sift.cpp:541-682's
radius, clamped to the largest radius class): its (2r + 3)^2 float32
gauss patch read once and (2r + 1)^2 window samples of ``SAMPLE_OPS``
float32 operations each; per lane of the buffer, its six 4-byte fields and
its valid byte read once and its 128 descriptor bytes written once.
``SAMPLE_OPS``, a transcendental call counted as one: rotation and bins
10, gradient, magnitude, angle and weight 14, the three bins' weights 11,
eight histogram terms of three operations 24."""

import math

from benchmark.counts import PEAKS, least_seconds
from benchmark.counts.kernel_F import octaves
from benchmark.reference.sift_plain import DEFAULTS, DESC_HIST_WIDTH, desc_radii

SAMPLE_OPS = 59
LANE_BYTES = 6 * 4 + 1 + 128


def radii(size, octave, h: int, w: int, params: dict) -> list[int]:
    """Window radii of keypoints of (input-image) ``size`` and ``octave``
    in an (h, w) frame, clamped to the largest class."""
    p = {**DEFAULTS, **params}
    shift = 1 if p["double_image_size"] else 0
    dims = octaves(h, w, p)
    r_max = desc_radii(p)[-1]
    out = []
    for s, o in zip(size, octave):
        hw = p["desc_scale_factor"] * s / math.pow(2, o - shift)
        t = hw * 0.5 * math.sqrt(2.0) * (DESC_HIST_WIDTH + 1.0) + 0.5
        ho, wo = dims[o]
        out.append(min(int(math.floor(t + 0.5)), int(math.sqrt(wo * wo + ho * ho)), r_max))
    return out


def work(r: list[int], lanes: int) -> tuple[float, float]:
    """(bytes, float32 operations) of one launch over ``lanes`` lanes whose
    valid keypoints have window radii ``r``."""
    nbytes = 4.0 * sum((2 * x + 3) ** 2 for x in r) + LANE_BYTES * lanes
    return nbytes, float(SAMPLE_OPS * sum((2 * x + 1) ** 2 for x in r))


def least(r: list[int], lanes: int) -> float:
    """I's least seconds over launches of ``lanes`` lanes in all whose valid
    keypoints have window radii ``r``."""
    nbytes, ops = work(r, lanes)
    return least_seconds(nbytes, ops, PEAKS["f32_ops_per_s"])
