"""Kernel I: the descriptor stage in one launch.

``describe_kernel`` is the wrapper of ``csrc/describe.cu``: the 128-byte
descriptors of a whole (B, n) post-dedup keypoint buffer, one CTA a lane,
read straight from a gauss gather space (``gather.StackSpace`` or
``gather.MultiRows`` in any of its three row orders).  Nothing is compacted
and nothing is read back: the space's layout, the per-octave tables and the
constants go to the kernel by value, invalid lanes get zero bytes from the
kernel itself.  It replaces no TPU kernel (the JAX package computes
descriptors with XLA); on the card it takes the place of the plain chain of
``models/descriptor.py`` (``_descriptors`` over ``gather.by_radius_class``),
which stays the CPU's and float64's path.

The kernel adds each histogram bin's contributions in row-major order of
the lane's window samples and takes each sum of squares as a fixed tree
over the 128 bins (see the ``.cu``).  ``describe_ordered_plain`` is that
order in plain PyTorch: the plain chain's per-lane arguments, patches
(``gather.gather_patches``, the spaces' own ``index``) and sample factors
(``models/descriptor``), summed in the kernel's order.  It equals the
kernel bit for bit on the card, so the card's tests hold the kernel's
index rule to the spaces' own; nothing on any route calls it.  Its bytes
differ from the plain chain's by the order of the sums alone.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from sift_tpu_torch import kernels
from sift_tpu_torch.config import (
    DESC_HIST_BINS,
    DESC_MAGNITUDE_THR,
    INT_DESCR_FCTR,
    M_PI2,
    SiftConfig,
)
from sift_tpu_torch.ops.gather import MultiRows, StackSpace, by_radius_class, gather_patches
from sift_tpu_torch.utils import profiling

# csrc/describe.cu: MAXV, the modes.
MAXV = 16
MODE_STACK, MODE_ROWS, MODE_STRIPS, MODE_LAYER_MINOR = range(4)
# The kernel's shared memory holds a (2 rmax + 3)^2 patch and 2 rmax + 1
# gaussian factors beside about 6 KB of its own: at most 227 KB.
MAX_RMAX = 115


@dataclasses.dataclass(frozen=True)
class Layout:
    """A gauss gather space's index rule as plain numbers, per volume: the
    fields of ``csrc/describe.cu``'s ``DescArgs`` that ``space_index``
    reads.  ``rt``: rows per image (``MultiRows``) or elements per image
    (``StackSpace``)."""

    mode: int
    rt: int
    blk: int
    l0: int
    base: tuple
    H: tuple
    W: tuple
    nb: tuple
    ls: tuple
    nl: tuple
    s_max: int


def layout_of(sp) -> Layout:
    """The ``Layout`` of a ``StackSpace`` or ``MultiRows``; any other
    space raises (describe reads no other)."""
    shapes = sp.shapes
    nv = len(shapes)
    if nv > MAXV:
        raise ValueError(f"describe: {nv} volumes, at most {MAXV}")
    hs = tuple(int(s[1]) for s in shapes)
    ws = tuple(int(s[2]) for s in shapes)
    zeros = (0,) * nv
    s_max = int(shapes[0][0]) - 1
    if isinstance(sp, StackSpace):
        return Layout(MODE_STACK, int(sp.total), 0, 0, tuple(map(int, sp.bases)), hs, ws,
                      zeros, zeros, zeros, s_max)
    if isinstance(sp, MultiRows):
        if sp.shp is None:
            mode = MODE_ROWS
        else:
            mode = MODE_STRIPS if sp.nls is None else MODE_LAYER_MINOR
        return Layout(mode, int(sp.rows.shape[-2]), int(sp.blk), int(sp.l0),
                      tuple(map(int, sp.bases)), hs, ws, tuple(map(int, sp.nbs)),
                      tuple(map(int, sp.shp or zeros)), tuple(map(int, sp.nls or zeros)), s_max)
    raise TypeError(f"describe: no kernel index mode for {type(sp).__name__}")


def octave_tables(sp, cfg: SiftConfig, octave_of_volume=None):
    """(o0, pow_denom, diag) per volume, the values ``_lane_args``' ``lut``
    tables hold: each volume's scale 1 / 2^(octave - shift) and diagonal
    sqrt(W^2 + H^2), as Python floats (float32 once on the card)."""
    oov = octave_of_volume or tuple(range(len(sp.shapes)))
    shift = 1 if cfg.double_image_size else 0
    pow_denom = tuple(1.0 / math.pow(2, o - shift) for o in oov)
    diag = tuple(math.sqrt(s[2] * s[2] + s[1] * s[1]) for s in sp.shapes)
    return oov[0], pow_denom, diag


class _Args(ctypes.Structure):
    """csrc/describe.cu's ``DescArgs``, field by field."""

    _v = ctypes.c_int * MAXV
    _f = ctypes.c_float * MAXV
    _fields_ = [
        ("rt", ctypes.c_longlong), ("base", ctypes.c_longlong * MAXV),
        ("mode", ctypes.c_int), ("nvol", ctypes.c_int), ("blk", ctypes.c_int),
        ("l0", ctypes.c_int),
        ("H", _v), ("W", _v), ("nb", _v), ("ls", _v), ("nl", _v),
        ("pow_denom", _f), ("diag", _f),
        ("n", ctypes.c_int), ("lanes", ctypes.c_int), ("o0", ctypes.c_int),
        ("s_max", ctypes.c_int), ("rmax", ctypes.c_int),
        ("dsf", ctypes.c_float), ("sqrt2", ctypes.c_float), ("pi2", ctypes.c_float),
        ("obin", ctypes.c_float), ("thr", ctypes.c_float),
    ]


def _args(lay: Layout, tables, cfg: SiftConfig, n: int, lanes: int, rmax: int) -> _Args:
    o0, pow_denom, diag = tables
    nv = len(lay.H)

    def pad(t):
        return list(t) + [0] * (MAXV - nv)

    a = _Args(rt=lay.rt, mode=lay.mode, nvol=nv, blk=lay.blk, l0=lay.l0, n=n, lanes=lanes,
              o0=o0, s_max=lay.s_max, rmax=rmax, dsf=cfg.desc_scale_factor,
              sqrt2=math.sqrt(2.0), pi2=M_PI2, obin=DESC_HIST_BINS / M_PI2,
              thr=DESC_MAGNITUDE_THR)
    a.base[:] = pad(lay.base)
    for f in ("H", "W", "nb", "ls", "nl"):
        getattr(a, f)[:] = pad(getattr(lay, f))
    a.pow_denom[:] = pad(pow_denom)
    a.diag[:] = pad(diag)
    return a


@functools.cache
def _launcher():
    fn = kernels.load("describe").describe_launch
    p = ctypes.c_void_p
    fn.argtypes = [p] * 11
    fn.restype = ctypes.c_int
    return fn


def describe_kernel(sp, kp, cfg: SiftConfig, rmax: int,
                    octave_of_volume: tuple[int, ...] | None = None) -> torch.Tensor:
    """Descriptors of a (B, n) keypoint buffer from the gauss gather space
    ``sp``: (B, n, 128) uint8, zero on invalid lanes, each lane in the
    window min(radius, ``rmax``), in one launch of kernel I on the current
    stream.  ``kp``'s x, y, size, pori: contiguous float32; octave, layer:
    int32; valid: bool; ``sp.flat`` contiguous float32, all on one card.
    ``octave_of_volume``: as in ``compute_descriptors_all``.  ``launches``
    counts launches."""
    flat = sp.flat
    bsz, n = kp.x.shape
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError("describe_kernel: the gather space must be contiguous float32")
    want = dict(x=torch.float32, y=torch.float32, size=torch.float32, pori=torch.float32,
                octave=torch.int32, layer=torch.int32, valid=torch.bool)
    for f, dt in want.items():
        t = getattr(kp, f)
        if t.dtype != dt or tuple(t.shape) != (bsz, n) or not t.is_contiguous():
            raise ValueError(f"describe_kernel: kp.{f} must be a contiguous ({bsz}, {n}) {dt} "
                             "tensor")
    if not 0 <= rmax <= MAX_RMAX:
        raise ValueError(f"describe_kernel: rmax {rmax} outside [0, {MAX_RMAX}]")
    lay = layout_of(sp)
    dev = flat.device
    if dev.type != "cuda" or any(getattr(kp, f).device != dev for f in want):
        raise ValueError("describe_kernel: the gather space and kp must lie on one card")
    out = torch.empty((bsz, n, 128), dtype=torch.uint8, device=dev)
    if bsz * n == 0:
        return out
    args = _args(lay, octave_tables(sp, cfg, octave_of_volume), cfg, n, bsz * n, rmax)
    with torch.cuda.device(dev):
        err = _launcher()(
            ctypes.addressof(args), flat.data_ptr(), kp.x.data_ptr(), kp.y.data_ptr(),
            kp.size.data_ptr(), kp.pori.data_ptr(), kp.octave.data_ptr(), kp.layer.data_ptr(),
            kp.valid.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "describe")
    describe_kernel.launches += 1
    profiling.count("describe.kernel_lanes", bsz * n)
    profiling.count("describe.kernel_launches", 1)
    return out


describe_kernel.launches = 0


def _tree_sum(a: torch.Tensor) -> torch.Tensor:
    """(L, 128) -> (L,): the kernel's fixed-order sum, s[k] += s[k + w]
    for w = 64, 32, ..., 1."""
    while a.shape[1] > 1:
        w = a.shape[1] // 2
        a = a[:, :w] + a[:, w:]
    return a[:, 0]


def hist_to_desc_ordered(hist: torch.Tensor) -> torch.Tensor:
    """``models/descriptor.hist_to_desc`` with the kernel's sums of
    squares (``_tree_sum``)."""

    def inv_norm(a):
        norm = torch.sqrt(_tree_sum(a * a))[:, None]
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        return torch.where(norm > 0, torch.reciprocal(safe), torch.zeros_like(norm))

    h = (hist * inv_norm(hist)).clamp_max(DESC_MAGNITUDE_THR)
    val = torch.floor(INT_DESCR_FCTR * h * inv_norm(h)).to(torch.int32)
    return val.clamp_max(255).to(torch.uint8)


def _ordered_window(sp, args, r: int) -> torch.Tensor:
    """(L, 128) uint8 of L valid lanes (``_lane_args``' arguments) in the
    window of radius ``r`` (at least each lane's own, or ``rmax``): the
    plain chain's patches and factors, summed in the kernel's order."""
    from sift_tpu_torch.models.descriptor import window_factors

    img, o, layer, xc, yc, x, y, radius, hw, ca, sa, pori, wl, hl = args
    nc, side = len(img), 2 * r + 1
    patches = gather_patches(sp, img, o, layer, yc - r - 1, xc - r - 1, 2 * r + 3)
    fr, fc, fo = window_factors(patches, x, y, radius, hw, ca, sa, pori, wl, hl, r, True)
    hist = torch.zeros((nc, 128), dtype=torch.float32, device=patches.device)
    for i in range(side):  # row-major: row offset i, then column offset j
        row = slice(i * side, (i + 1) * side)
        contrib = ((fr[:, row, :, None] * fc[:, row, None, :])[..., None]
                   * fo[:, row, None, None, :]).reshape(nc, side, 128)
        for j in range(side):
            hist = hist + contrib[:, j]
    return hist_to_desc_ordered(hist)


def describe_ordered_plain(sp, kp, cfg: SiftConfig, radii,
                           octave_of_volume: tuple[int, ...] | None = None) -> torch.Tensor:
    """Same contract as ``describe_kernel`` with rmax = ``radii[-1]``, in
    plain PyTorch, float32, on any device: the plain chain's per-lane
    arguments (``models/descriptor._lane_args``, which the kernel computes
    in registers) and patches, and the kernel's order of sums.  Each valid
    lane runs in the window of its class of ``radii``
    (``gather.by_radius_class``); a larger window adds exact zeros only, so
    the bytes do not depend on ``radii`` beyond its last entry."""
    from sift_tpu_torch.models.descriptor import _RADIUS, _lane_args

    bsz, n = kp.x.shape
    desc = torch.zeros((bsz * n, 128), dtype=torch.uint8, device=kp.x.device)
    lanes, args = _lane_args(sp, kp, cfg, octave_of_volume)
    if len(lanes):
        chunk = 2048 if kp.x.device.type == "cuda" else 128
        desc[lanes] = by_radius_class(args[_RADIUS], list(radii), chunk, args,
                                      lambda a, r: _ordered_window(sp, a, r))
    return desc.reshape(bsz, n, 128)
