"""One octave of the pyramid: the blur chain and its DoGs.

``octave_blur`` is the wrapper of kernel C (``octave_blur_launch`` in
``csrc/octave_front.cu``), the port of the TPU kernel
``sift_tpu/ops/pallas_pyramid.py::fused_octave_blur``.  ``octave_blur_plain``
is its plain PyTorch version: the ``ops/blur.separable_blur`` chain and the
subtraction.  A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sift_tpu_torch import kernels
from sift_tpu_torch.config import half_kernel_weight_sum
from sift_tpu_torch.ops.blur import separable_blur

MAX_LAYERS = 8  # csrc/octave_front.cu MAX_LAYERS / MAX_TAPS
MAX_TAPS = 16


def octave_blur_plain(seed: torch.Tensor, half_kernels, blur=separable_blur):
    """seed ([B,] H, W) -> (gauss ([B,] n+1, H, W) with the seed as layer 0,
    dogs ([B,] n, H, W) with dogs[i] = gauss[i+1] - gauss[i]).  ``blur``
    (img, half_kernel) runs each layer's blur."""
    layers = [seed]
    for hk in half_kernels:
        layers.append(blur(layers[-1], hk))
    g = torch.stack(layers, dim=-3)
    return g, g[..., 1:, :, :] - g[..., :-1, :, :]


def tap_arrays(half_kernels):
    """The blur chain as csrc/octave_front.cu takes it: (taps (n, MAX_TAPS)
    float32, ntaps (n,) int32, sum_w (n,) float32) host arrays."""
    n = len(half_kernels)
    taps = np.zeros((n, MAX_TAPS), np.float32)
    for k, hk in enumerate(half_kernels):
        taps[k, : len(hk)] = hk
    ntaps = np.asarray([len(hk) for hk in half_kernels], np.int32)
    sum_w = np.asarray([half_kernel_weight_sum(list(hk)) for hk in half_kernels], np.float32)
    return taps, ntaps, sum_w


def octave_blur(seed: torch.Tensor, half_kernels):
    """Same contract as ``octave_blur_plain``; kernel C on a CUDA tensor."""
    if seed.device.type == "cpu":
        return octave_blur_plain(seed, half_kernels)
    if seed.device.type != "cuda":
        raise ValueError(f"octave_blur: unsupported device {seed.device}")
    n = len(half_kernels)
    if seed.dtype != torch.float32 or seed.dim() != 3 or not seed.is_contiguous():
        raise ValueError("octave_blur: seed must be a contiguous (B, H, W) float32 tensor")
    if not 1 <= n <= MAX_LAYERS or any(not 1 <= len(hk) <= MAX_TAPS for hk in half_kernels):
        raise ValueError("octave_blur: kernel takes 1..8 blur layers of 1..16 taps")
    bsz, h, w = seed.shape
    gauss = torch.empty((bsz, n + 1, h, w), dtype=torch.float32, device=seed.device)
    dogs = torch.empty((bsz, n, h, w), dtype=torch.float32, device=seed.device)
    taps, ntaps, sum_w = tap_arrays(half_kernels)
    fn = _launcher()
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream(seed.device).cuda_stream
        err = fn(seed.data_ptr(), gauss.data_ptr(), dogs.data_ptr(), bsz, h, w, n,
                 taps.ctypes.data, ntaps.ctypes.data, sum_w.ctypes.data, stream)
    kernels.check(err, "octave_blur")
    return gauss, dogs


def _launcher():
    fn = kernels.load("octave_front").octave_blur_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, p, p, p, p]
    fn.restype = i
    return fn
