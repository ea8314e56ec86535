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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sift_tpu_torch import kernels
from sift_tpu_torch.ops.gather import cube_rows_params, cube_rows_plain


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
    with torch.cuda.device(d.device):
        err = _launcher()(d.data_ptr(), out.data_ptr(), b, s, h, w, strip.bit_length() - 1,
                          out.shape[1], base, torch.cuda.current_stream(d.device).cuda_stream)
    kernels.check(err, "cube_pack")
    cube_pack_rows.launches += 1
    return out


cube_pack_rows.launches = 0


@functools.cache
def _launcher():
    fn = kernels.load("cube_pack").cube_pack_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, i, i, i, i, i, ll, ll, p]
    fn.restype = i
    return fn
