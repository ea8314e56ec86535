"""General 2D convolution (the JAX package's ``ops/conv.py``).

Rebuild of apply_convolution (src/image.cpp:94-121): generic square-kernel
2D convolution with zero padding, as one ``F.conv2d``.  The reference's
apply_gaussian_blur (src/image.cpp:127-150) builds a 2D gaussian kernel and
calls this; its normalization loop divides only the first ``kernel_size``
taps (src/image.cpp:145-147), a latent bug in dead code (the live pipeline
only uses the separable blur), which is not replicated:
``gaussian_kernel_2d`` normalizes correctly.  No route of the pipeline
calls this module.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def apply_convolution(img: torch.Tensor, kernel) -> torch.Tensor:
    """(..., H, W) (x) (k, k) -> (..., H, W), zero padding (src/image.cpp:108).

    Follows the reference's index convention: out[x, y] = sum_{u,v}
    img[x+u, y+v] * kernel[u+r, v+r], i.e. cross-correlation with the first
    kernel axis along x (columns).  ``F.conv2d`` is a cross-correlation over
    (H, W), so the kernel goes in transposed, as in the JAX package.
    """
    img = torch.as_tensor(img)
    k = torch.as_tensor(kernel).to(dtype=img.dtype, device=img.device)
    x = img.reshape((-1, 1) + tuple(img.shape[-2:]))
    out = F.conv2d(x, k.T.contiguous()[None, None], padding="same")
    return out.reshape(img.shape)


def gaussian_kernel_2d(sigma: float) -> np.ndarray:
    """Normalized 2D gaussian, size 2*ceil(3*sigma)+1 (src/image.cpp:128)."""
    size = 2 * int(math.ceil(3 * sigma)) + 1
    r = size // 2
    xs = np.arange(size) - r
    g = np.exp(-(xs[:, None] ** 2 + xs[None, :] ** 2) / (2 * sigma * sigma))
    g /= 2 * math.pi * sigma * sigma
    return g / g.sum()


def subtract(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Elementwise img1 - img2 (src/image.cpp:30-36); DoG values go negative
    and are never clamped."""
    return img1 - img2
