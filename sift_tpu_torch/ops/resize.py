"""Resampling (src/image.cpp:41-88), bit-exact in the reference's order."""

from __future__ import annotations

import torch


def downsample_nearest_x2(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H//2, W//2), out[j, i] = img[2j, 2i]."""
    h, w = img.shape[-2], img.shape[-1]
    return img[..., 0 : (h // 2) * 2 : 2, 0 : (w // 2) * 2 : 2]


def upsample_bilinear(img: torch.Tensor, fx: int, fy: int) -> torch.Tensor:
    """Integer-factor bilinear upsample matching src/image.cpp:62-88.

    Power-of-two factors (the live use: the initial 2x doubling) decompose
    by output phase: the fractional parts are exactly px/fx and py/fy, so
    the op is fy*fx weighted sums of edge-clamped shifts interleaved by a
    reshape, with the reference's lerp order
    v0 = v00*(1-dx) + v10*dx; v1 = ...; v = v0*(1-dy) + v1*dy.
    """
    if fx & (fx - 1) or fy & (fy - 1):
        raise ValueError("only power-of-two factors are ported")
    h, w = img.shape[-2], img.shape[-1]
    right = torch.cat([img[..., :, 1:], img[..., :, -1:]], dim=-1)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    diag = torch.cat([down[..., :, 1:], down[..., :, -1:]], dim=-1)
    phase_rows = []
    for py in range(fy):
        dy = py / fy
        row = []
        for px in range(fx):
            dx = px / fx
            v0 = img * (1.0 - dx) + right * dx
            v1 = down * (1.0 - dx) + diag * dx
            row.append(v0 * (1.0 - dy) + v1 * dy)
        phase_rows.append(torch.stack(row, dim=-1))  # (..., h, w, fx)
    out = torch.stack(phase_rows, dim=-3)  # (..., h, fy, w, fx)
    return out.reshape(*img.shape[:-2], h * fy, w * fx)
