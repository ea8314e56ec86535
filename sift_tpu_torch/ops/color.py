"""BT.709 grayscale (src/image.cpp:8-24), in the reference's order."""

from __future__ import annotations

import torch


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., H, W); pass-through for one channel or 2-D."""
    if img.dim() >= 3 and img.shape[-1] == 1:
        return img[..., 0]
    if img.dim() == 2:
        return img
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    # C++ evaluation order: (0.2126*r + 0.7152*g) + 0.0722*b
    return (0.2126 * r + 0.7152 * g) + 0.0722 * b
