"""Cube-packed DoG rows of one octave.

``cube_pack_rows`` is the wrapper of kernel G (``csrc/cube_pack.cu``), the
port of the TPU kernel ``sift_tpu/ops/pallas_relayout.py::cube_pack_rows``:
one launch packs an octave's plain DoG stack into the 128-lane rows that
``gather.CubeRows`` reads, into a buffer of its own or into the front-twin
route's shared buffer at the octave's base row (the fallback octave of
``models/pyramid.front_twin_pyramids``).  Its plain version is
``gather.cube_rows_plain`` (one unfold and a transpose).  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Pure data movement.

``walk_plain`` is the kernel's schedule in plain numpy, unit by unit (ROWS
image rows x a chunk of blocks, staged from the 4-aligned column below the
chunk's first window, then written row by row), for the CPU tests; its
constants and ``chunking`` mirror the ``.cu``'s.  Change the schedule
there first.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sift_tpu_torch import kernels
from sift_tpu_torch.ops.gather import cube_rows_params, cube_rows_plain

# csrc/cube_pack.cu: ROWS, THREADS, TILE_FLOATS.
ROWS = 8
THREADS = 256
TILE_FLOATS = 12288


def tile_width(nbc: int, stride: int) -> int:
    """Staged floats per row of a unit of ``nbc`` blocks: the windows'
    nbc * stride + 3 columns plus up to 3 of alignment shift, rounded up to
    a multiple of 4 (the kernel's ``tile_width``)."""
    return (nbc * stride + 6 + 3) & ~3


def chunking(n: int, nbp: int, stride: int) -> tuple[int, int]:
    """(nbc, nchunks): blocks a work unit takes, the most whose staged tile
    (n * ROWS rows of ``tile_width``) fits TILE_FLOATS, balanced over the
    chunks of a row (the kernel's ``chunking``)."""
    most = 1
    while most < nbp and n * ROWS * tile_width(most + 1, stride) <= TILE_FLOATS:
        most += 1
    nchunks = -(-nbp // most)
    return -(-nbp // nchunks), nchunks


def cube_pack_rows(d: torch.Tensor, strip: int = 64, out: torch.Tensor | None = None,
                   base: int = 0) -> torch.Tensor:
    """d (B, S, H, W) -> its packed rows (B, ceil(H / strip) * strip * nbp,
    128) in the strip-block-major order (``strip`` a power of two).  With
    ``out`` (B, P, 128) the rows are written in place from row ``base`` (a
    multiple of nbp * strip) and ``out`` is returned; every row of that
    region is written, no other."""
    if strip < 1 or strip & (strip - 1):
        raise ValueError("cube_pack_rows: strip must be a power of two")
    if d.dim() != 4:
        raise ValueError("cube_pack_rows: d must be (B, S, H, W)")
    b, s, h, w = d.shape
    _, _, nbp = cube_rows_params(s, w)
    nrows = -(-h // strip) * strip * nbp
    if out is None:
        out, base = torch.empty((b, nrows, 128), dtype=d.dtype, device=d.device), 0
    if (out.dim() != 3 or out.shape[0] != b or out.shape[2] != 128 or base % (nbp * strip)
            or not 0 <= base <= out.shape[1] - nrows or out.dtype != d.dtype
            or out.device != d.device or not out.is_contiguous()):
        raise ValueError("cube_pack_rows: out / base do not hold this octave's rows")
    if d.device.type == "cpu":
        out[:, base: base + nrows] = cube_rows_plain(d, strip)
        return out
    if d.device.type != "cuda":
        raise ValueError(f"cube_pack_rows: unsupported device {d.device}")
    if d.dtype != torch.float32 or not d.is_contiguous():
        raise ValueError("cube_pack_rows: d must be contiguous float32")
    if out.data_ptr() % 16:
        raise ValueError("cube_pack_rows: out must be 16-byte aligned")
    with torch.cuda.device(d.device):
        err = _launcher()(d.data_ptr(), out.data_ptr(), b, s, h, w, strip.bit_length() - 1,
                          out.shape[1], base, torch.cuda.current_stream(d.device).cuda_stream)
    kernels.check(err, "cube_pack")
    return out


def walk_plain(d: torch.Tensor, strip: int, out: torch.Tensor, base: int) -> np.ndarray:
    """The kernel's schedule in plain numpy: every work unit (chunk, row
    group, image) stages its layers' ROWS rows over its chunk's columns from
    the 4-aligned column at or below the first window's, zero outside [0, W)
    and past H, and writes its packed rows into ``out`` (B, P, 128), a CPU
    tensor, from row ``base``; rows past the strip-padded height are
    skipped, lanes >= S * sw are zeros.  ``d``: a CPU tensor (B, S, H, W).
    Returns how often each (image, row) of ``out`` was written."""
    x = d.numpy()
    o = out.numpy()
    bsz, n, h, w = x.shape
    stride, sw, nbp = cube_rows_params(n, w)
    ls = strip.bit_length() - 1
    hpad = -(-h // strip) * strip
    nbc, nchunks = chunking(n, nbp, stride)
    cw = tile_width(nbc, stride)
    lane = np.arange(n * sw)
    lz, lj = lane // sw, lane % sw  # each lane's layer and window column
    writes = np.zeros(o.shape[:2], np.int64)
    for bi in range(bsz):
        for g in range(-(-hpad // ROWS)):
            y0 = g * ROWS
            for ch in range(nchunks):
                cb0 = ch * nbc
                nb = min(nbc, nbp - cb0)
                c0 = cb0 * stride - 1
                a0 = c0 & ~3 if c0 >= 0 else -4
                shift = c0 - a0
                ncols = (shift + nb * stride + 3 + 3) & ~3
                assert ncols <= cw and n * ROWS * cw <= TILE_FLOATS
                tile = np.zeros((n, ROWS, cw), o.dtype)
                r1 = min(ROWS, h - y0)
                lo, hi = max(a0, 0), min(a0 + ncols, w)
                if r1 > 0 and hi > lo:
                    tile[:, :r1, lo - a0: hi - a0] = x[bi, :, y0: y0 + r1, lo:hi]
                for r in range(ROWS):
                    y = y0 + r
                    if y >= hpad:
                        continue
                    cb = cb0 + np.arange(nb)
                    rows = base + ((((y >> ls) * nbp + cb) << ls) + (y & (strip - 1)))
                    vals = np.zeros((nb, 128), o.dtype)
                    vals[:, : n * sw] = tile[lz, r, shift + lj + (cb - cb0)[:, None] * stride]
                    o[bi, rows] = vals
                    writes[bi, rows] += 1
    return writes


@functools.cache
def _launcher():
    fn = kernels.load("cube_pack").cube_pack_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, i, i, i, i, i, ll, ll, p]
    fn.restype = i
    return fn
