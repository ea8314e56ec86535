"""Kernel K: the orientation stage in one launch.

``orient_kernel`` is the wrapper of ``csrc/describe.cu``'s second kernel:
the orientation candidates of a whole (B, n) refined keypoint buffer, one
warp a lane, read straight from a gauss gather space (``gather.StackSpace``
or ``gather.MultiRows`` in any of its three row orders, the staged path's
one-octave spaces included).  Nothing is compacted and nothing is read
back: the space's layout (``describe.layout_of``), the per-octave tables
(``describe.octave_tables``) and kernel I's argument struct go to the
kernel by value beside the stage's own constants (``_OriArgs``); invalid
lanes get invalid candidates from the kernel itself.  It replaces no TPU
kernel (the JAX package assigns orientations with XLA); on the card it
takes the place of the plain chain of ``models/orient.py``
(``orient_plain``: one-hot contractions over ``gather.by_radius_class``,
the smoothing bin by bin), which stays the CPU's and float64's path.

The kernel adds each histogram bin's contributions in row-major order of
the lane's window samples (see the ``.cu``).  ``orient_ordered_plain`` is
that order in plain PyTorch: the plain chain's per-lane arguments, patches
and samples (``models/orient``), each bin summed in the kernel's order, then
the plain chain's smoothing, peaks and slots.  It equals the kernel bit for
bit on the card, so the card's tests hold the kernel's index rule and
arithmetic to the plain chain's; nothing on any route calls it.  Its
candidates differ from the plain chain's by the order of the histogram's
sums alone, and on slots past a lane's peaks, where it writes pori 0.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from sift_tpu_torch import kernels
from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.ops.describe import _args, layout_of, octave_tables
from sift_tpu_torch.ops.gather import by_radius_class
from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.keypoints import Keypoints
from sift_tpu_torch.utils.numerics import device_const

# csrc/describe.cu: ORI_WARPS, MAXBINS, MAXSLOTS.
ORI_WARPS = 4
MAXBINS = 64
MAXSLOTS = 32
# Each of a CTA's ORI_WARPS lanes holds a (2 rmax + 3)^2 patch and 2 rmax + 1
# gaussian factors in shared memory, beside 1.5 KB of static arrays: at most
# 227 KB.
MAX_RMAX = 58


class _OriArgs(ctypes.Structure):
    """csrc/describe.cu's ``OriArgs``, field by field."""

    _fields_ = [
        ("nbins", ctypes.c_int), ("slots", ctypes.c_int), ("sigma", ctypes.c_float),
        ("ratio", ctypes.c_float), ("pi", ctypes.c_float), ("halve", ctypes.c_float),
    ]


def _ori_args(cfg: SiftConfig) -> _OriArgs:
    return _OriArgs(nbins=cfg.num_bins, slots=cfg.ori_cand_slots, sigma=cfg.ori_sigma_factor,
                    ratio=cfg.peak_ratio, pi=math.pi,
                    halve=0.5 if cfg.double_image_size else 1.0)


@functools.lru_cache(maxsize=256)
def _launch_args(lay, tables, cfg: SiftConfig, n: int, lanes: int, rmax: int):
    """The two structs of a launch, built once a process for each set of
    numbers (the launcher copies them; nothing writes to them)."""
    return _args(lay, tables, cfg, n, lanes, rmax), _ori_args(cfg)


@functools.cache
def _launcher():
    fn = kernels.load("describe").orient_launch
    p = ctypes.c_void_p
    fn.argtypes = [p] * 18
    fn.restype = ctypes.c_int
    return fn


def orient_kernel(sp, kp: Keypoints, cfg: SiftConfig, rmax: int,
                  octave_of_volume: tuple[int, ...] | None = None):
    """Orientation candidates of a (B, n) keypoint buffer from the gauss
    gather space ``sp``, in one launch of kernel K on the current stream:
    ``orient_all``'s (candidates (B, n * slots), max_peaks) with pori 0 on
    slots past a lane's peaks, each lane in the window min(radius,
    ``rmax``).  The candidates' descriptors are a zero view of no memory.
    ``kp``'s x, y, size: contiguous float32; octave, layer: int32; valid:
    bool; ``sp.flat`` contiguous float32, all on one card.
    ``octave_of_volume``: as in ``orient_all``."""
    flat = sp.flat
    bsz, n = kp.x.shape
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError("orient_kernel: the gather space must be contiguous float32")
    want = dict(x=torch.float32, y=torch.float32, size=torch.float32, octave=torch.int32,
                layer=torch.int32, valid=torch.bool)
    for f, dt in want.items():
        t = getattr(kp, f)
        if t.dtype != dt or tuple(t.shape) != (bsz, n) or not t.is_contiguous():
            raise ValueError(f"orient_kernel: kp.{f} must be a contiguous ({bsz}, {n}) {dt} "
                             "tensor")
    if not 0 <= rmax <= MAX_RMAX:
        raise ValueError(f"orient_kernel: rmax {rmax} outside [0, {MAX_RMAX}]")
    if not (1 <= cfg.num_bins <= MAXBINS and 1 <= cfg.ori_cand_slots <= MAXSLOTS):
        raise ValueError(f"orient_kernel: {cfg.num_bins} bins and {cfg.ori_cand_slots} slots, "
                         f"at most {MAXBINS} and {MAXSLOTS}")
    lay = layout_of(sp)
    dev = flat.device
    if dev.type != "cuda" or any(getattr(kp, f).device != dev for f in want):
        raise ValueError("orient_kernel: the gather space and kp must lie on one card")
    shape = (bsz, n * cfg.ori_cand_slots)
    # x, y, size, pori, then octave and layer as int32 views: one allocation.
    x, y, size, pori, octave, layer = torch.empty((6, *shape), dtype=torch.float32,
                                                  device=dev).unbind(0)
    cand = Keypoints(x=x, y=y, octave=octave.view(torch.int32), layer=layer.view(torch.int32),
                     size=size, pori=pori,
                     desc=device_const(0, torch.uint8, dev).expand(*shape, 128),
                     valid=torch.empty(shape, dtype=torch.bool, device=dev))
    if bsz * n == 0:
        return cand, torch.zeros((), dtype=torch.int32, device=dev)
    max_peaks = torch.empty((), dtype=torch.int32, device=dev)  # the launcher zeroes it
    args, oargs = _launch_args(lay, octave_tables(sp, cfg, octave_of_volume), cfg, n, bsz * n,
                               rmax)
    with torch.cuda.device(dev):
        err = _launcher()(
            ctypes.addressof(args), ctypes.addressof(oargs), flat.data_ptr(), kp.x.data_ptr(),
            kp.y.data_ptr(), kp.size.data_ptr(), kp.octave.data_ptr(), kp.layer.data_ptr(),
            kp.valid.data_ptr(), cand.x.data_ptr(), cand.y.data_ptr(), cand.size.data_ptr(),
            cand.octave.data_ptr(), cand.layer.data_ptr(), cand.pori.data_ptr(),
            cand.valid.data_ptr(), max_peaks.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "orient")
    profiling.count("orient.kernel_lanes", bsz * n)
    profiling.count("orient.kernel_launches", 1)
    return cand, max_peaks


def _ordered_histograms(sp, args, nb: int, r: int, fast: bool) -> torch.Tensor:
    """(L, nb) raw histograms of L valid lanes (``_lane_args``' arguments)
    in the window of radius ``r``: the plain chain's samples, each bin
    summed in row-major sample order."""
    from sift_tpu_torch.models.orient import _samples

    contrib, h_idx = _samples(sp, *args, nb, r, fast)
    hist = torch.zeros((len(contrib), nb), dtype=contrib.dtype, device=contrib.device)
    for s in range(contrib.shape[1]):  # one term a row: each sum in sample order
        hist.scatter_add_(1, h_idx[:, s:s + 1], contrib[:, s:s + 1])
    return hist


def orient_ordered_plain(sp, kp: Keypoints, cfg: SiftConfig, radii,
                         octave_of_volume: tuple[int, ...] | None = None):
    """Same contract as ``orient_kernel`` with rmax = ``radii[-1]``, in
    plain PyTorch on any device (float64 too, in the plain chain's float64
    arithmetic): the plain chain's per-lane arguments
    (``models/orient._lane_args``, which the kernel computes in registers),
    patches and samples, the kernel's order of sums, then the plain chain's
    smoothing, peaks and slots.  Each valid lane runs in the
    window of its class of ``radii`` (``gather.by_radius_class``); a larger
    window adds exact zeros only, so the candidates do not depend on
    ``radii`` beyond its last entry."""
    from sift_tpu_torch.models.orient import _RADIUS, _lane_args, candidates

    nb = cfg.num_bins
    fast = kp.x.dtype != torch.float64
    lanes, args = _lane_args(sp, kp, cfg, octave_of_volume)
    if len(lanes):
        chunk = 2048 if kp.x.device.type == "cuda" else 256
        hist = by_radius_class(args[_RADIUS], list(radii), chunk, args,
                               lambda a, r: _ordered_histograms(sp, a, nb, r, fast))
    else:
        hist = torch.zeros((0, nb), dtype=kp.x.dtype, device=kp.x.device)
    cand, max_peaks = candidates(kp, cfg, lanes, hist)
    cand.pori = torch.where(cand.valid, cand.pori, torch.zeros_like(cand.pori))
    return cand, max_peaks

