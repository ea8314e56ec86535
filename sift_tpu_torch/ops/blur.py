"""Separable gaussian blur with the reference's border semantics.

Taps clamp to the border pixel and the result is divided by the constant
applied-weight sum (src/image.cpp:156-238), accumulated in the C++ order:
    acc  = img * k[0]
    acc  = acc + k[u] * (img[+u] + img[-u])    for u = 1..K-1
    acc  = acc / sum_w
horizontal pass first, then vertical.  This is the plain version of the
blur chain inside kernel A (ops/octave_front.py), which repeats the same
IEEE operations one by one, so the two agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sift_tpu_torch.config import gaussian_half_kernel, half_kernel_weight_sum
from sift_tpu_torch.utils.numerics import xdiv


def _one_axis(a: torch.Tensor, taps, sum_w: float, dim: int) -> torch.Tensor:
    n = a.shape[dim]
    base = torch.arange(n, device=a.device)
    acc = a * taps[0]
    for u in range(1, len(taps)):
        hi = a.index_select(dim, (base + u).clamp_max(n - 1))
        lo = a.index_select(dim, (base - u).clamp_min(0))
        acc = acc + taps[u] * (hi + lo)
    return xdiv(acc, sum_w)


def separable_blur(img: torch.Tensor, half_kernel: list[float]) -> torch.Tensor:
    """(..., H, W) blur; taps are the unnormalized one-sided kernel."""
    sum_w = half_kernel_weight_sum(half_kernel)
    tmp = _one_axis(img, half_kernel, sum_w, img.dim() - 1)
    return _one_axis(tmp, half_kernel, sum_w, img.dim() - 2)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur per src/image.cpp:220-238 (kernel size ceil(3*sigma)+1)."""
    return separable_blur(img, gaussian_half_kernel(sigma))


def full_kernel(half_kernel: list[float]) -> np.ndarray:
    """The symmetric full kernel, float64, normalised by the reference's
    applied-weight sum ``sum_w``."""
    k = np.asarray(half_kernel, np.float64)
    return np.concatenate([k[:0:-1], k]) / half_kernel_weight_sum(half_kernel)
