"""One separable gaussian blur through kernel D.

``separable_blur_kernel`` is the wrapper of kernel D (``csrc/blur_pass.cu``),
the port of the TPU kernel ``sift_tpu/ops/pallas_blur.py::
pallas_separable_blur``: one launch per blur, both passes.  Its plain
version is ``ops/blur.separable_blur``.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

``blur_rolling_plain`` is the kernel's row schedule in plain PyTorch (the
way ``ops/octave_rolling`` models kernels A, C and F): tile by tile and
strip by strip, a ring of horizontal-pass rows addressed by ``row % depth``
whose slots carry the row they hold, so a ring that is too shallow fails on
the CPU.  It equals ``separable_blur`` bit for bit, and nothing on any
route calls it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sift_tpu_torch import kernels
from sift_tpu_torch.config import half_kernel_weight_sum
from sift_tpu_torch.ops.blur import separable_blur
from sift_tpu_torch.ops import octave_rolling
from sift_tpu_torch.ops.octave_rolling import _Ring
from sift_tpu_torch.utils.numerics import xdiv

# csrc/blur_pass.cu: MAX_TAPS, TILE_W, BATCH_ROWS (its FILL_ROWS and
# MIN_STRIP are octave_rolling's).
MAX_TAPS = 16
TILE_W = 256
BATCH_ROWS = 8


def separable_blur_kernel(img: torch.Tensor, half_kernel) -> torch.Tensor:
    """Same contract as ``separable_blur`` for (B, H, W); kernel D on CUDA
    (one launch per blur)."""
    if img.device.type == "cpu":
        return separable_blur(img, half_kernel)
    if img.device.type != "cuda":
        raise ValueError(f"separable_blur_kernel: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 3 or not img.is_contiguous():
        raise ValueError("separable_blur_kernel: img must be a contiguous (B, H, W) float32 tensor")
    if not 1 <= len(half_kernel) <= MAX_TAPS:
        raise ValueError("separable_blur_kernel: a half kernel has 1..16 taps")
    taps, sum_w = _taps(tuple(half_kernel))
    out = torch.empty_like(img)
    bsz, h, w = img.shape
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _launcher()(img.data_ptr(), out.data_ptr(), bsz, h, w, taps.ctypes.data,
                          len(taps), sum_w, stream)
    kernels.check(err, "blur_pass")
    return out


@functools.cache
def _taps(half_kernel: tuple) -> tuple[np.ndarray, float]:
    """A half kernel as the launcher takes it: float32 taps and sum_w."""
    return np.asarray(half_kernel, np.float32), float(np.float32(half_kernel_weight_sum(list(half_kernel))))


@functools.cache
def _launcher():
    fn = kernels.load("blur_pass").blur_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, p, i, ctypes.c_float, p]
    fn.restype = i
    return fn


def launch_plan(bsz: int, h: int, w: int, ntaps: int) -> tuple[int, int, int]:
    """(strip rows, resident CTAs an SM, SMs) that the launcher takes for a
    blur of (bsz, h, w) with ``ntaps`` taps on the current CUDA device."""
    out = [ctypes.c_int() for _ in range(3)]
    kernels.check(_planner()(bsz, h, w, ntaps, *(ctypes.byref(o) for o in out)), "blur_plan")
    return tuple(o.value for o in out)


@functools.cache
def _planner():
    fn = kernels.load("blur_pass").blur_plan
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, i, i, p, p, p]
    fn.restype = i
    return fn


def strip_rows_for(bsz: int, h: int, w: int, r: int, ctas_per_sm: int,
                   sm_count: int = octave_rolling.SM_COUNT) -> int:
    """Rows of a CTA's strip, the launcher's rule (``octave_rolling.
    strip_rows_for`` with kernel D's tile, halo r and sm_count x
    ctas_per_sm slots; the launcher asks the runtime for both)."""
    return octave_rolling.strip_rows_for(bsz, h, w, r, TILE_W, sm_count * ctas_per_sm)


def blur_rolling_plain(img: torch.Tensor, half_kernel, strip_rows: int | None = None,
                       batch_rows: int = BATCH_ROWS, tile_w: int = TILE_W) -> torch.Tensor:
    """([B,] H, W) -> the blur of ``separable_blur``, computed in kernel D's
    schedule: per column tile and row strip, steps of ``batch_rows``
    horizontal rows into a ring of 2r + batch_rows rows, then the output
    rows whose vertical taps are in the ring.  ``strip_rows`` defaults to
    one strip of every row (the launcher's choice below 2 * MIN_STRIP
    rows); ``strip_rows_for`` gives the launcher's strips elsewhere."""
    batched = img.dim() == 3
    if not batched:
        img = img[None]
    bsz, h, w = img.shape
    taps = list(half_kernel)
    r = len(taps) - 1
    sum_w = half_kernel_weight_sum(taps)
    strip = strip_rows or h
    out = img.new_full(img.shape, float("nan"))
    for ys in range(0, h, strip):
        ye = min(ys + strip, h)
        for x0 in range(0, w, tile_w):
            _walk_tile(img, out, taps, sum_w, ys, ye, x0, batch_rows, tile_w)
    return out if batched else out[0]


def _walk_tile(img, out, taps, sum_w, ys, ye, x0, batch_rows, tile_w):
    """One CTA: the column tile [x0, x0 + tile_w) of every image over output
    rows [ys, ye)."""
    _, h, w = img.shape
    r = len(taps) - 1
    ring = _Ring(img, 2 * r + batch_rows, tile_w)
    # An input row's columns, clamped at the load: x0 - r .. x0 + tile_w + r.
    cols = torch.arange(x0 - r, x0 + tile_w + r).clamp(0, w - 1)
    hi = min(h, ye + r)
    hn, vn = max(0, ys - r), ys
    while vn < ye:
        for y in range(hn, min(hn + batch_rows, hi)):  # step 1: one row a warp
            raw = img[:, y, cols]
            acc = raw[:, r: r + tile_w] * taps[0]
            for u in range(1, r + 1):
                acc = acc + taps[u] * (raw[:, r + u: r + u + tile_w] + raw[:, r - u: r - u + tile_w])
            ring.put(y, xdiv(acc, sum_w))
        hn = min(hn + batch_rows, hi)
        lim = ye if hn == hi else min(ye, hn - r)
        for y in range(vn, vn + max(0, min(batch_rows, lim - vn))):  # step 2
            acc = ring.get(y) * taps[0]
            for u in range(1, r + 1):  # clamp the row first, map to a slot second
                acc = acc + taps[u] * (ring.get(min(y + u, h - 1)) + ring.get(max(y - u, 0)))
            x1 = min(x0 + tile_w, w)
            out[:, y, x0:x1] = xdiv(acc, sum_w)[:, : x1 - x0]
            vn = y + 1
