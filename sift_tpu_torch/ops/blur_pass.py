"""One separable gaussian blur through kernel D.

``separable_blur_kernel`` is the wrapper of kernel D (``csrc/blur_pass.cu``),
the port of the TPU kernel ``sift_tpu/ops/pallas_blur.py::
pallas_separable_blur``: two launches, the horizontal pass and then the
vertical one.  Its plain version is ``ops/blur.separable_blur``.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sift_tpu_torch import kernels
from sift_tpu_torch.config import half_kernel_weight_sum
from sift_tpu_torch.ops.blur import separable_blur

MAX_TAPS = 16  # csrc/blur_pass.cu MAX_TAPS


def separable_blur_kernel(img: torch.Tensor, half_kernel) -> torch.Tensor:
    """Same contract as ``separable_blur`` for (B, H, W); kernel D on CUDA.
    ``launches`` counts kernel launches (two per blur)."""
    if img.device.type == "cpu":
        return separable_blur(img, half_kernel)
    if img.device.type != "cuda":
        raise ValueError(f"separable_blur_kernel: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 3 or not img.is_contiguous():
        raise ValueError("separable_blur_kernel: img must be a contiguous (B, H, W) float32 tensor")
    if not 1 <= len(half_kernel) <= MAX_TAPS:
        raise ValueError("separable_blur_kernel: a half kernel has 1..16 taps")
    taps = np.asarray(half_kernel, np.float32)
    sum_w = float(np.float32(half_kernel_weight_sum(list(half_kernel))))
    fn = _launcher()
    tmp = torch.empty_like(img)
    out = torch.empty_like(img)
    bsz, h, w = img.shape
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        for src, dst, axis in ((img, tmp, 1), (tmp, out, 0)):
            err = fn(src.data_ptr(), dst.data_ptr(), bsz, h, w, taps.ctypes.data,
                     len(taps), sum_w, axis, stream)
            kernels.check(err, "blur_pass")
            separable_blur_kernel.launches += 1
    return out


separable_blur_kernel.launches = 0


def _launcher():
    fn = kernels.load("blur_pass").blur_pass_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, p, i, ctypes.c_float, i, p]
    fn.restype = i
    return fn
