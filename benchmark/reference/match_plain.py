"""Lowe's ratio test, plain (src/sift.cpp:783-815): the yardstick's matcher.

Descriptors are uint8, so squared distances are integers below 2^23 and
float64 holds every partial sum exactly, whatever the GEMM's order or its
TF32 setting.  The first column wins a tie for the best; a copy of the
best counts as the second best.  ``best < ratio * second`` is tested on
squared distances as the exact integer predicate ``den * best < num *
second`` for ratio^2 = num / den.
"""

from __future__ import annotations

from fractions import Fraction

import torch

HUGE = 1 << 24


def ratio_matches(desc1: torch.Tensor, desc2: torch.Tensor, ratio: float = 0.75):
    """(best_idx (N,) int64, accept (N,) bool, best squared distance (N,)
    int64) of every row of ``desc1`` ((N, 128) uint8) against every row of
    ``desc2`` ((M, 128) uint8)."""
    n, m = len(desc1), len(desc2)
    if m == 0 or n == 0:
        zero = torch.zeros(n, dtype=torch.int64, device=desc1.device)
        return zero, zero.bool(), zero + HUGE
    a, b = desc1.to(torch.float64), desc2.to(torch.float64)
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)).to(torch.int64)
    idx = torch.argmin(d2, dim=1)
    best = d2.gather(1, idx[:, None])[:, 0]
    cols = torch.arange(m, device=d2.device)
    second = torch.where(cols[None, :] == idx[:, None], torch.full_like(d2, HUGE), d2).amin(1)
    frac = Fraction(ratio * ratio).limit_denominator(64)
    if abs(float(frac) - ratio * ratio) < 1e-12:
        accept = (frac.denominator * best) < (frac.numerator * second)
    else:
        accept = best.to(torch.float64) < ratio * ratio * second.to(torch.float64)
    return idx, accept & (best < HUGE), best
