"""Descriptor matching: one-directional Lowe ratio test (src/sift.cpp:783-815).

The top-2 search is kernel B on the card (ops/top2.py).  Descriptors are
uint8, so squared distances are exact integers and the ratio test
``best < 0.75 * second`` becomes the exact predicate 16*best^2 < 9*second^2
(sqrt is monotone), bit-faithful to the C++ float64 comparison.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from sift_tpu_torch.ops.top2 import HUGE_D2, top2
from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.numerics import resolve_device


def pairwise_sq_dists(desc1, desc2, device="cuda") -> torch.Tensor:
    """(N, M) int32 exact squared L2 distances between uint8 descriptor
    sets (N, 128) and (M, 128), tensors or arrays, on ``device``.

    ||a||^2 + ||b||^2 - 2 a.b^T in float32, the product by ``torch.matmul``
    with TF32 off (the package sets it), as the JAX package leaves it to
    XLA.  Every partial sum is an integer below 2^24 (a norm or a dot
    product is at most 128 * 255^2 < 2^23, two norms together below 2^24),
    so each is exact in float32 and the result is exact in any summation
    order.  The matcher does not go through it: its top-2 is kernel B,
    which never forms the matrix.
    """
    dev = resolve_device(device)
    a, b = (torch.as_tensor(d).to(dev).to(torch.float32) for d in (desc1, desc2))
    g = a @ b.T
    na = (a * a).sum(1)
    nb = (b * b).sum(1)
    return (na[:, None] + nb[None, :] - 2.0 * g).to(torch.int32)


def ratio_accept(best, second, valid1, ratio_threshold: float = 0.75):
    """Lowe's test on exact squared distances; a lone valid target always
    accepts (second == HUGE), an empty target set never does."""
    r2 = ratio_threshold * ratio_threshold
    frac = Fraction(r2).limit_denominator(64)
    if abs(float(frac) - r2) < 1e-12:
        accept = (frac.denominator * best) < (frac.numerator * second)
    else:
        accept = best.float() < torch.tensor(r2, dtype=torch.float32) * second.float()
    return accept & valid1 & (best < HUGE_D2)


def match_descriptors(desc1, valid1, desc2, valid2, ratio_threshold: float = 0.75,
                      device="cuda"):
    """(best_idx, accept, best_d2, second_d2) per row of ``desc1``.

    Inputs are (N, 128) / (N,) for one pair or (P, N, 128) / (P, N) for P
    pairs (tensors or arrays); outputs have the matching leading shape.
    First index wins ties; duplicates of the best count as second best.
    """
    dev = resolve_device(device)
    with profiling.span("sift.match"):
        d1, v1, d2, v2 = (torch.as_tensor(a).to(dev) for a in (desc1, valid1, desc2, valid2))
        single = d1.dim() == 2
        if single:
            d1, v1, d2, v2 = d1[None], v1[None], d2[None], v2[None]
        best, second, idx = top2(
            d1.to(torch.uint8).contiguous(), d2.to(torch.uint8).contiguous(), v2.bool()
        )
        accept = ratio_accept(best, second, v1.bool(), ratio_threshold)
        out = (idx, accept, best, second)
    return tuple(o[0] for o in out) if single else out
