"""The octave front: blur chain, DoG, extremum mask and popcounts.

``octave_front`` is the wrapper of kernel A (``csrc/octave_front.cu``), the
port of the TPU kernels ``sift_tpu/ops/pallas_pyramid.py::fused_octave_front``
and the value outputs of ``fused_octave_front_twin``.  ``octave_front_plain``
is its plain PyTorch version, with the semantics of the JAX package's
``models/detect.octave_front_xla``.  A CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from sift_tpu_torch import kernels
from sift_tpu_torch.config import half_kernel_weight_sum
from sift_tpu_torch.ops.octave_blur import MAX_LAYERS, MAX_TAPS, octave_blur_plain


def extremum_mask(dog: torch.Tensor, threshold: float, window_size: int = 3):
    """26-neighbour extremum mask over the interior of (..., D, H, W) DoG
    stacks, shape (..., D-2b, H-2b, W-2b) (src/sift.cpp:227-291): >= all
    window values or <= all of them (ties allowed), and |centre| > thr."""
    b = window_size // 2

    def pool(a, dim, op):
        n = a.shape[dim]
        out = None
        for u in range(window_size):
            piece = a.narrow(dim, u, n - 2 * b)
            out = piece if out is None else op(out, piece)
        return out

    wmax, wmin = dog, dog
    for dim in (-1, -2, -3):
        wmax = pool(wmax, dim, torch.maximum)
        wmin = pool(wmin, dim, torch.minimum)
    center = dog[..., b:-b, b:-b, b:-b]
    return (center.abs() > threshold) & ((center >= wmax) | (center <= wmin))


def octave_front_plain(seed, half_kernels, threshold: float, window_size: int = 3):
    """seed (B, H, W) -> (gauss (B, S, H, W) with the seed as layer 0,
    dogs (B, S-1, H, W), mask (B, S-3, H, nbm*128) 0/1 in the seed's dtype,
    counts (B, S-3, H, nbm) int32); mask border rows/columns and lanes >= W
    are zero."""
    g, dogs = octave_blur_plain(seed, half_kernels)
    bsz, h, w = seed.shape
    nbm = -(-w // 128)
    b = window_size // 2
    m = extremum_mask(dogs, threshold, window_size)
    mask = F.pad(
        m.to(seed.dtype),
        (b, nbm * 128 - m.shape[-1] - b, b, h - m.shape[-2] - b),
    )
    counts = mask.reshape(bsz, mask.shape[1], h, nbm, 128).sum(
        -1, dtype=torch.int32
    )
    return g, dogs, mask, counts


def octave_front(seed, half_kernels, threshold: float, window_size: int = 3):
    """Same contract as ``octave_front_plain``; kernel A on a CUDA tensor."""
    if seed.device.type == "cpu":
        return octave_front_plain(seed, half_kernels, threshold, window_size)
    if seed.device.type != "cuda":
        raise ValueError(f"octave_front: unsupported device {seed.device}")
    n = len(half_kernels)
    if seed.dtype != torch.float32 or seed.dim() != 3 or not seed.is_contiguous():
        raise ValueError("octave_front: seed must be a contiguous (B, H, W) float32 tensor")
    if window_size != 3 or not 3 <= n <= MAX_LAYERS:
        raise ValueError("octave_front: kernel takes window 3 and 3..8 blur layers")
    if any(len(hk) > MAX_TAPS for hk in half_kernels):
        raise ValueError("octave_front: a half kernel exceeds 16 taps")
    bsz, h, w = seed.shape
    nbm = -(-w // 128)
    dev = seed.device
    gauss = torch.empty((bsz, n + 1, h, w), dtype=torch.float32, device=dev)
    dogs = torch.empty((bsz, n, h, w), dtype=torch.float32, device=dev)
    mask = torch.empty((bsz, n - 2, h, nbm * 128), dtype=torch.float32, device=dev)
    counts = torch.empty((bsz, n - 2, h, nbm), dtype=torch.int32, device=dev)
    taps = np.zeros((n, MAX_TAPS), np.float32)
    for k, hk in enumerate(half_kernels):
        taps[k, : len(hk)] = hk
    ntaps = np.asarray([len(hk) for hk in half_kernels], np.int32)
    sum_w = np.asarray(
        [half_kernel_weight_sum(list(hk)) for hk in half_kernels], np.float32
    )
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            seed.data_ptr(), gauss.data_ptr(), dogs.data_ptr(), mask.data_ptr(),
            counts.data_ptr(), bsz, h, w, n,
            taps.ctypes.data, ntaps.ctypes.data, sum_w.ctypes.data,
            float(np.float32(threshold)), stream,
        )
    kernels.check(err, "octave_front")
    octave_front.launches += 1
    return gauss, dogs, mask, counts


octave_front.launches = 0


def _launcher():
    fn = kernels.load("octave_front").octave_front_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p, ctypes.c_float, p]
    fn.restype = i
    return fn
