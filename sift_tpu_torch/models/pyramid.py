"""Gaussian / DoG pyramid (src/sift.cpp:113-225).

Counterpart of ``sift_tpu/models/pyramid.py``.  ``build_pyramids`` builds
each octave with kernel C (ops/octave_blur.py) when ``cfg.use_octave_kernel``
resolves on, else with the ``_blur`` chain, and seeds the next octave from
gauss layer ``intervals`` decimated by two (src/sift.cpp:195-196).  Every
blur outside kernel C goes through ``_blur``: kernel D (ops/blur_pass.py)
in float32, whose wrapper is the plain blur on a CPU tensor.
``front_pyramids`` is the front route's builder (kernel A per octave).
"""

from __future__ import annotations

import math

import torch

from sift_tpu_torch.config import SiftConfig, gaussian_half_kernel, kernel_on
from sift_tpu_torch.ops.blur import separable_blur
from sift_tpu_torch.ops.blur_pass import separable_blur_kernel
from sift_tpu_torch.ops.color import to_grayscale
from sift_tpu_torch.ops.octave_blur import octave_blur, octave_blur_plain
from sift_tpu_torch.ops.octave_front import octave_front
from sift_tpu_torch.ops.resize import downsample_nearest_x2, upsample_bilinear


def _blur(img: torch.Tensor, half_kernel) -> torch.Tensor:
    """One (B, H, W) blur: kernel D's wrapper in float32, the plain blur in
    float64 (the parity profile; the kernels take float32 only, like the
    JAX package's)."""
    if img.dtype == torch.float32:
        return separable_blur_kernel(img.contiguous(), half_kernel)
    return separable_blur(img, half_kernel)


def compute_initial_image(img: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """Grayscale -> optional 2x bilinear upsample -> blur sqrt(sigma^2 - 1)
    (src/sift.cpp:113-126, including the pre-blur without doubling)."""
    gray = to_grayscale(img).to(cfg.dtype)
    if cfg.double_image_size:
        gray = upsample_bilinear(gray, 2, 2)
    sigma = math.sqrt(cfg.init_sigma * cfg.init_sigma - 1)
    return _blur(gray, gaussian_half_kernel(sigma))


def blur_half_kernels(cfg: SiftConfig) -> list[list[float]]:
    """The incremental blurs of one octave (layers 1..S-1)."""
    return [gaussian_half_kernel(s) for s in cfg.gaussian_kernels()[1:]]


def build_pyramids(initial: torch.Tensor, cfg: SiftConfig, octaves: int):
    """initial (B, H, W) -> (gaussians, dogs): per octave, gauss (B, S, H_o,
    W_o) with the seed as layer 0 and DoG (B, S-1, H_o, W_o)."""
    hks = blur_half_kernels(cfg)
    gaussians, dogs = [], []
    img = initial.contiguous()
    for _ in range(octaves):
        if kernel_on(cfg.use_octave_kernel, img.dtype, img.device):
            g, d = octave_blur(img, hks)
        else:
            g, d = octave_blur_plain(img, hks, _blur)
        gaussians.append(g)
        dogs.append(d)
        img = downsample_nearest_x2(g[:, g.shape[1] - 3]).contiguous()
    return gaussians, dogs


def front_pyramids(initial: torch.Tensor, cfg: SiftConfig, octaves: int):
    """initial (B, H, W) -> per-octave lists (gauss (B, S, H_o, W_o), dogs
    (B, S-1, H_o, W_o), masks, counts) from the octave front (kernel A on
    the card): the front route's builder."""
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
