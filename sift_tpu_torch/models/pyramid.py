"""Gaussian / DoG pyramid (src/sift.cpp:113-225).

``build_pyramids`` runs every octave through the octave front
(ops/octave_front.py: kernel A on the card, its plain version on the CPU)
and seeds the next octave from gauss layer ``intervals`` decimated by two
(src/sift.cpp:195-196).
"""

from __future__ import annotations

import math

import torch

from sift_tpu_torch.config import SiftConfig, gaussian_half_kernel
from sift_tpu_torch.ops.blur import separable_blur
from sift_tpu_torch.ops.color import to_grayscale
from sift_tpu_torch.ops.octave_front import octave_front
from sift_tpu_torch.ops.resize import downsample_nearest_x2, upsample_bilinear


def compute_initial_image(img: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """Grayscale -> optional 2x bilinear upsample -> blur sqrt(sigma^2 - 1)
    (src/sift.cpp:113-126, including the pre-blur without doubling)."""
    gray = to_grayscale(img).to(cfg.dtype)
    if cfg.double_image_size:
        gray = upsample_bilinear(gray, 2, 2)
    sigma = math.sqrt(cfg.init_sigma * cfg.init_sigma - 1)
    return separable_blur(gray, gaussian_half_kernel(sigma))


def blur_half_kernels(cfg: SiftConfig) -> list[list[float]]:
    """The incremental blurs of one octave (layers 1..S-1)."""
    return [gaussian_half_kernel(s) for s in cfg.gaussian_kernels()[1:]]


def build_pyramids(initial: torch.Tensor, cfg: SiftConfig, octaves: int):
    """initial (B, H, W) -> per-octave lists (gauss (B, S, H_o, W_o), dogs
    (B, S-1, H_o, W_o), masks, counts) from the octave front."""
    hks = blur_half_kernels(cfg)
    thr = cfg.extremum_threshold()
    gaussians, dogs, masks, counts = [], [], [], []
    img = initial.contiguous()
    for _ in range(octaves):
        g, d, m, c = octave_front(img, hks, thr, cfg.window_size)
        gaussians.append(g)
        dogs.append(d)
        masks.append(m)
        counts.append(c)
        img = downsample_nearest_x2(g[:, g.shape[1] - 3]).contiguous()
    return gaussians, dogs, masks, counts
