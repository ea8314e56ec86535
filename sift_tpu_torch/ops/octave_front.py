"""The octave front: blur chain, DoG, extremum mask and popcounts.

``octave_front`` is the wrapper of kernel A (``csrc/octave_front.cu``), the
port of the TPU kernel ``sift_tpu/ops/pallas_pyramid.py::fused_octave_front``.
``octave_front_plain`` is its plain PyTorch version, with the semantics of
the JAX package's ``models/detect.octave_front_xla``.

``octave_front_twin`` is the wrapper of kernel F (``octave_front_twin_launch``
in the same source), the port of ``pallas_pyramid.py::
fused_octave_front_twin``: the same values, written straight into the
front-twin route's two shared gather buffers (gauss twin rows, cube-packed
DoG rows) with no plain stack.  ``octave_front_twin_plain`` is its plain
version: ``octave_front_plain``, then ``gather.twin_strided`` and
``gather.cube_rows_plain``.  ``front_twin_strip`` is the JAX package's
choice of each octave's row strip, which fixes those layouts.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from sift_tpu_torch import kernels
from sift_tpu_torch.ops.gather import cube_rows_params, cube_rows_plain, twin_strided
from sift_tpu_torch.ops.octave_blur import MAX_LAYERS, MAX_TAPS, octave_blur_plain, tap_arrays


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


def _check_kernel_input(what: str, seed, half_kernels, window_size: int):
    """Raise unless kernels A and F take this seed and blur chain."""
    if seed.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {seed.device}")
    if seed.dtype != torch.float32 or seed.dim() != 3 or not seed.is_contiguous():
        raise ValueError(f"{what}: seed must be a contiguous (B, H, W) float32 tensor")
    if window_size != 3 or not 3 <= len(half_kernels) <= MAX_LAYERS:
        raise ValueError(f"{what}: kernel takes window 3 and 3..8 blur layers")
    if any(len(hk) > MAX_TAPS for hk in half_kernels):
        raise ValueError(f"{what}: a half kernel exceeds 16 taps")


def octave_front(seed, half_kernels, threshold: float, window_size: int = 3):
    """Same contract as ``octave_front_plain``; kernel A on a CUDA tensor."""
    if seed.device.type == "cpu":
        return octave_front_plain(seed, half_kernels, threshold, window_size)
    _check_kernel_input("octave_front", seed, half_kernels, window_size)
    n = len(half_kernels)
    bsz, h, w = seed.shape
    nbm = -(-w // 128)
    dev = seed.device
    gauss = torch.empty((bsz, n + 1, h, w), dtype=torch.float32, device=dev)
    dogs = torch.empty((bsz, n, h, w), dtype=torch.float32, device=dev)
    mask = torch.empty((bsz, n - 2, h, nbm * 128), dtype=torch.float32, device=dev)
    counts = torch.empty((bsz, n - 2, h, nbm), dtype=torch.int32, device=dev)
    taps, ntaps, sum_w = tap_arrays(half_kernels)
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
    return gauss, dogs, mask, counts


def _launcher():
    fn = kernels.load("octave_front").octave_front_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p, ctypes.c_float, p]
    fn.restype = i
    return fn


def pick_strip_front_twin(w: int, halo: int, n: int, nl: int, blk: int,
                          itemsize: int = 4) -> int | None:
    """The JAX package's ``pick_strip_front_twin``: the largest power-of-two
    row strip whose working set, by that package's own estimate for its
    kernel, stays within its budget; None if none does.  The port's kernel
    has no such limit: the strip only fixes the layouts, and the port keeps
    the JAX package's so that both packages' buffers agree."""
    nbm = -(-w // 128)
    nbt = -(-w // blk)
    wpm = nbm * 128
    n_int = n - 2
    for strip in (256, 128, 64, 32, 16, 8):
        ext = -(-(strip + 2 * halo) // 8) * 8
        est = itemsize * (
            2 * ext * w
            + 2 * strip * nl * nbt * 2 * blk
            + 2 * strip * -(-w // 20) * 128
            + n * strip * w
            + 2 * strip * (n_int * wpm + n_int * nbm + w)
            + 6 * ext * w
            + 3 * (strip + 2) * w
            + 2 * 3 * strip * w
        )
        if est <= 80 * 1024 * 1024:
            return strip
    return None


def front_twin_strip(shape, half_kernels, n_keep_gauss: int, blk: int = 64,
                     dtype=torch.float32) -> int | None:
    """The row strip of an octave of ``shape`` (..., H, W) in the
    front-twin layouts (the JAX package's ``front_twin_strip``); None where
    the JAX package's kernel would not take the octave (then the route's
    fallback builds it, ``models/pyramid.front_twin_pyramids``)."""
    if dtype != torch.float32:
        return None
    h, w = shape[-2], shape[-1]
    front_halo = sum(len(hk) - 1 for hk in half_kernels) + 1
    halo = -(-front_halo // 8) * 8
    strip = pick_strip_front_twin(w, halo, len(half_kernels), n_keep_gauss, blk)
    if strip is None:
        return None
    hp2 = 1 << max(h - 1, 7).bit_length()  # smallest power of two >= max(h, 8)
    return min(strip, max(32, hp2))


def _twin_regions(seed, n: int, gbuf, gbase: int, strip: int, blk: int, g_nl: int,
                  pkbuf, pkbase: int):
    """Check the two buffers against this octave's regions; returns
    (gauss twin rows, packed rows) of the octave."""
    bsz, h, w = seed.shape
    if strip < 1 or strip & (strip - 1):
        raise ValueError("octave_front_twin: strip must be a power of two")
    nstrips = -(-h // strip)
    g_unit = g_nl * -(-w // blk) * strip
    pk_unit = cube_rows_params(n, w)[2] * strip
    for buf, base, unit, width, name in ((gbuf, gbase, g_unit, 2 * blk, "gbuf"),
                                         (pkbuf, pkbase, pk_unit, 128, "pkbuf")):
        if (buf.dim() != 3 or buf.shape[0] != bsz or buf.shape[2] != width
                or buf.dtype != seed.dtype or buf.device != seed.device
                or not buf.is_contiguous()):
            raise ValueError(f"octave_front_twin: {name} must be contiguous (B, rows, {width})")
        if base < 0 or (unit and base % unit) or base + nstrips * unit > buf.shape[1]:
            raise ValueError(f"octave_front_twin: {name} does not hold this octave at row {base}")
    return nstrips * g_unit, nstrips * pk_unit


def octave_front_twin_plain(seed, half_kernels, threshold: float, gbuf, gbase: int,
                            strip: int, blk: int, g_l0: int, g_nl: int, pkbuf, pkbase: int,
                            window_size: int = 3):
    """seed (B, H, W) -> (mask, counts, down): the octave front whose gauss
    layers [g_l0, g_l0 + g_nl) are written in place into ``gbuf`` (B, G,
    2 * blk) from row ``gbase`` as strip-major / layer-minor twin rows, and
    whose DoGs are written in place into ``pkbuf`` (B, P, 128) from row
    ``pkbase`` as cube-packed rows, both in strips of ``strip`` rows (the
    layouts of ``gather.MultiRows`` with ``nls`` and ``gather.CubeRows``).
    mask and counts as ``octave_front_plain``; ``down`` is the plain gauss
    layer S - 3, the next octave's seed.  The buffers must hold zeros in the
    octave's regions: lanes past the image and rows past H keep them."""
    g_rows, pk_rows = _twin_regions(seed, len(half_kernels), gbuf, gbase, strip, blk, g_nl,
                                    pkbuf, pkbase)
    g, dogs, mask, counts = octave_front_plain(seed, half_kernels, threshold, window_size)
    gbuf[:, gbase: gbase + g_rows] = twin_strided(g, blk, strip, g_l0, g_nl)
    pkbuf[:, pkbase: pkbase + pk_rows] = cube_rows_plain(dogs, strip)
    return mask, counts, g[:, g.shape[1] - 3].contiguous()


def octave_front_twin(seed, half_kernels, threshold: float, gbuf, gbase: int, strip: int,
                      blk: int, g_l0: int, g_nl: int, pkbuf, pkbase: int,
                      window_size: int = 3):
    """Same contract as ``octave_front_twin_plain``; kernel F on a CUDA
    tensor."""
    if seed.device.type == "cpu":
        return octave_front_twin_plain(seed, half_kernels, threshold, gbuf, gbase, strip, blk,
                                       g_l0, g_nl, pkbuf, pkbase, window_size)
    _check_kernel_input("octave_front_twin", seed, half_kernels, window_size)
    n = len(half_kernels)
    if not 0 <= g_l0 <= g_l0 + g_nl <= n + 1:
        raise ValueError("octave_front_twin: stored layers outside the gauss stack")
    _twin_regions(seed, n, gbuf, gbase, strip, blk, g_nl, pkbuf, pkbase)
    bsz, h, w = seed.shape
    nbm = -(-w // 128)
    dev = seed.device
    mask = torch.empty((bsz, n - 2, h, nbm * 128), dtype=torch.float32, device=dev)
    counts = torch.empty((bsz, n - 2, h, nbm), dtype=torch.int32, device=dev)
    down = torch.empty((bsz, h, w), dtype=torch.float32, device=dev)
    taps, ntaps, sum_w = tap_arrays(half_kernels)
    fn = kernels.load("octave_front").octave_front_twin_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p, p, ctypes.c_float,
                   ll, ll, i, i, i, i, ll, ll, p]
    fn.restype = i
    with torch.cuda.device(dev):
        err = fn(
            seed.data_ptr(), gbuf.data_ptr(), pkbuf.data_ptr(), mask.data_ptr(),
            counts.data_ptr(), down.data_ptr(), bsz, h, w, n,
            taps.ctypes.data, ntaps.ctypes.data, sum_w.ctypes.data,
            float(np.float32(threshold)), gbuf.shape[1], gbase, strip.bit_length() - 1, blk,
            g_l0, g_nl, pkbuf.shape[1], pkbase, torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(err, "octave_front_twin")
    return mask, counts, down
