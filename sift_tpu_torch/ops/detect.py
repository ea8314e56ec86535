"""Kernel J: stage 2 of the front routes in one launch.

``detect_kernel`` is the wrapper of ``csrc/detect.cu``: from the octave
fronts' extremum masks and popcounts and the DoG gather space (the
front-twin route's ``CubeRows``, the front route's ``StackSpace``) it
computes what ``models/detect.py``'s chain returns for ``detect_refine`` --
``extrema_from_counts``, the cascaded Newton refinement, the contrast and
edge tests and the compaction to ``kp_cap``, with the true counts -- bit for
bit, one CTA an image.  Nothing is read back and no table is built from host
values: the space's layout, the per-octave shapes, the cascade's schedule
(``refine_cascade_caps``) and the constants go to the kernel by value.  It
replaces no TPU kernel (the JAX package runs this stage with XLA); on the
card it takes the place of the plain chain, which stays the CPU's and
float64's path and the kernel's yardstick (``applies`` decides).

``space_index`` is the kernel's index rule in plain Python; the CPU tests
hold it to each space's own ``index``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from sift_tpu_torch import kernels
from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.ops.gather import CubeRows, StackSpace
from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.keypoints import Keypoints

# csrc/detect.cu: MAXV, MAXP, the modes.
MAXV = 16
MAXP = 4
MODE_STACK, MODE_CUBE_ROWS = 0, 1
# The kernel's dynamic shared memory, two bits a lane, stays under 227 KB
# beside its static arrays.
MAX_LANES = 768 * 1024


@dataclasses.dataclass(frozen=True)
class Layout:
    """A DoG gather space's index rule as plain numbers, per octave: the
    fields of ``csrc/detect.cu``'s ``DetectArgs`` that ``space_index`` and
    the cube clamps read.  ``rt``: elements (``StackSpace``) or packed rows
    (``CubeRows``) per image."""

    mode: int
    rt: int
    base: tuple
    S: tuple
    H: tuple
    W: tuple
    nbp: tuple
    ls: tuple
    stride: int
    sw: int
    width: int


def layout_of(sp) -> Layout:
    """The ``Layout`` of a ``CubeRows`` or ``StackSpace``; any other space
    raises ``TypeError`` (the kernel reads no other)."""
    shapes = sp.shapes
    nv = len(shapes)
    if nv > MAXV:
        raise ValueError(f"detect_kernel: {nv} octaves, at most {MAXV}")
    dims = [tuple(int(s[i]) for s in shapes) for i in range(3)]
    zeros = (0,) * nv
    if isinstance(sp, StackSpace):
        return Layout(MODE_STACK, int(sp.total), tuple(map(int, sp.bases)), *dims, zeros, zeros,
                      0, 0, 0)
    if isinstance(sp, CubeRows):
        return Layout(MODE_CUBE_ROWS, int(sp.rows.shape[-2]), tuple(map(int, sp.bases)), *dims,
                      tuple(map(int, sp.nbps)), tuple(map(int, sp.lss)), int(sp.stride),
                      int(sp.sw), int(sp.rows.shape[-1]))
    raise TypeError(f"detect_kernel: no kernel index mode for {type(sp).__name__}")


def space_index(lay: Layout, o: int, img: int, s: int, y: int, x: int, x0: int) -> int:
    """The kernel's flat offset of element (s, y, x) of octave ``o`` of image
    ``img``, the window starting at column ``x0`` (``space_index`` in the
    ``.cu``), one element in plain Python."""
    if lay.mode == MODE_STACK:
        return img * lay.rt + lay.base[o] + (s * lay.H[o] + y) * lay.W[o] + x
    nbp, ls = lay.nbp[o], lay.ls[o]
    cb = min(max(x0, 0) // lay.stride, nbp - 1)
    row = img * lay.rt + lay.base[o] + ((((y >> ls) * nbp) + cb) << ls) + (y & ((1 << ls) - 1))
    return row * lay.width + s * lay.sw + x - (cb * lay.stride - 1)


def applies(space, cfg: SiftConfig) -> bool:
    """Whether ``detect_refine`` takes kernel J: a float32 ``CubeRows`` or
    ``StackSpace`` on the card, window 3.  Everything else (the CPU,
    float64, other windows or spaces) takes the plain chain."""
    flat = space.flat
    return (isinstance(space, (CubeRows, StackSpace)) and flat.dtype == torch.float32
            and flat.device.type == "cuda" and cfg.window_size == 3)


class _Args(ctypes.Structure):
    """csrc/detect.cu's ``DetectArgs``, field by field."""

    _l = ctypes.c_longlong * MAXV
    _v = ctypes.c_int * MAXV
    _p = ctypes.c_int * MAXP
    _fields_ = [
        ("rt", ctypes.c_longlong), ("base", _l), ("counts", _l), ("masks", _l),
        ("mode", ctypes.c_int), ("nvol", ctypes.c_int), ("stride", ctypes.c_int),
        ("sw", ctypes.c_int), ("width", ctypes.c_int),
        ("S", _v), ("H", _v), ("W", _v), ("nbp", _v), ("ls", _v), ("nbm", _v),
        ("scale", ctypes.c_float * MAXV),
        ("n_int", ctypes.c_int), ("n", ctypes.c_int), ("kp_cap", ctypes.c_int),
        ("depth", ctypes.c_int), ("border", ctypes.c_int), ("nph", ctypes.c_int),
        ("cap", _p), ("steps", _p),
        ("c255", ctypes.c_float), ("intervals", ctypes.c_float), ("init_sigma", ctypes.c_float),
        ("contrast", ctypes.c_float), ("eigen_ratio", ctypes.c_float),
        ("edge_lim", ctypes.c_float),
    ]


def make_args(lay: Layout, masks, counts, cfg: SiftConfig, phases) -> _Args:
    """The launch's ``DetectArgs``: the layout, the masks' and popcounts'
    addresses and row blocks, the cascade's ``phases`` ((cap, steps), ...)
    and the chain's constants."""
    nv = len(lay.H)

    def pad(t, k=MAXV):
        return list(t) + [0] * (k - len(t))

    a = _Args(rt=lay.rt, mode=lay.mode, nvol=nv, stride=lay.stride, sw=lay.sw, width=lay.width,
              n_int=int(counts[0].shape[1]), n=cfg.extrema_cap, kp_cap=cfg.kp_cap,
              depth=lay.S[0], border=cfg.window_size // 2, nph=len(phases), c255=255.0,
              intervals=float(cfg.intervals), init_sigma=cfg.init_sigma,
              contrast=cfg.contrast_threshold, eigen_ratio=cfg.eigen_ratio,
              edge_lim=(cfg.eigen_ratio + 1) * (cfg.eigen_ratio + 1))
    a.base[:] = pad(lay.base)
    a.counts[:] = pad([c.data_ptr() for c in counts])
    a.masks[:] = pad([m.data_ptr() for m in masks])
    for f in ("S", "H", "W", "nbp", "ls"):
        getattr(a, f)[:] = pad(getattr(lay, f))
    a.nbm[:] = pad([int(c.shape[3]) for c in counts])
    a.scale[:] = pad([float(math.pow(2, o)) for o in range(nv)])
    a.cap[:] = pad([int(c) for c, _ in phases], MAXP)
    a.steps[:] = pad([int(s) for _, s in phases], MAXP)
    return a


@functools.cache
def _launcher():
    fn = kernels.load("detect").detect_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_int] + [p] * 16
    fn.restype = ctypes.c_int
    return fn


def _check(space, masks, counts, cfg: SiftConfig) -> tuple[Layout, int]:
    """Raise on what the kernel does not take: the space's kind and type,
    the masks' and popcounts' types, shapes and contiguity against the
    space's octaves, the window and the capacities.  Returns the layout and
    the batch size.  Reads no device."""
    lay = layout_of(space)
    flat = space.flat
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError("detect_kernel: the DoG gather space must be contiguous float32")
    if cfg.window_size != 3:
        raise ValueError(f"detect_kernel: window {cfg.window_size}, the kernel takes 3")
    nv = len(lay.H)
    if len(masks) != nv or len(counts) != nv:
        raise ValueError(f"detect_kernel: {len(masks)} masks, {len(counts)} popcounts for {nv} "
                         "octaves")
    bsz, n_int = (int(d) for d in counts[0].shape[:2])
    if n_int != lay.S[0] - 2 or any(s != lay.S[0] for s in lay.S):
        raise ValueError(f"detect_kernel: {n_int} mask layers for DoG stacks of {lay.S}")
    for o, (m, c) in enumerate(zip(masks, counts)):
        nbm = -(-lay.W[o] // 128)
        if c.dtype != torch.int32 or tuple(c.shape) != (bsz, n_int, lay.H[o], nbm):
            raise ValueError(f"detect_kernel: counts[{o}] must be ({bsz}, {n_int}, {lay.H[o]}, "
                             f"{nbm}) int32")
        if m.dtype != torch.float32 or tuple(m.shape) != (bsz, n_int, lay.H[o], nbm * 128):
            raise ValueError(f"detect_kernel: masks[{o}] must be ({bsz}, {n_int}, {lay.H[o]}, "
                             f"{nbm * 128}) float32")
        if not (m.is_contiguous() and c.is_contiguous()):
            raise ValueError(f"detect_kernel: masks[{o}] and counts[{o}] must be contiguous")
    if flat.numel() != bsz * lay.rt * max(lay.width, 1):
        raise ValueError(f"detect_kernel: a gather space of {flat.numel()} values for {bsz} "
                         "images")
    if not 1 <= cfg.extrema_cap <= MAX_LANES or cfg.kp_cap < 1:
        raise ValueError(f"detect_kernel: extrema_cap {cfg.extrema_cap} outside [1, {MAX_LANES}]"
                         f" or kp_cap {cfg.kp_cap} below 1")
    return lay, bsz


def detect_kernel(space, masks, counts, cfg: SiftConfig):
    """``models/sift.detect_refine``'s result, (keypoints (B, kp_cap),
    {"extrema", "refined", "refine_active"}), in one launch of kernel J on
    the current stream.  ``space``: the DoG ``CubeRows`` or ``StackSpace``;
    ``masks[o]`` (B, n_int, H_o, nbm_o * 128) float32 and ``counts[o]`` (B,
    n_int, H_o, nbm_o) int32, contiguous, all on one card."""
    from sift_tpu_torch.models.detect import refine_cascade_caps

    lay, bsz = _check(space, masks, counts, cfg)
    dev = space.flat.device
    if dev.type != "cuda" or any(t.device != dev for t in (*masks, *counts)):
        raise ValueError("detect_kernel: the gather space, masks and popcounts must lie on "
                         "one card")
    n, cap = cfg.extrema_cap, cfg.kp_cap
    phases = refine_cascade_caps(cfg, n)
    if len(phases) > MAXP:
        raise ValueError(f"detect_kernel: {len(phases)} cascade phases, at most {MAXP}")

    def new(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    x, y, size, pori = (new((bsz, cap), torch.float32) for _ in range(4))
    octave, layer = new((bsz, cap), torch.int32), new((bsz, cap), torch.int32)
    valid, desc = new((bsz, cap), torch.bool), new((bsz, cap, 128), torch.uint8)
    extrema, refined = new((bsz,), torch.int32), new((bsz,), torch.int32)
    n_active = new((bsz, len(phases)), torch.int32)
    ws_lane, ws_emit = new((bsz, n, 4), torch.int32), new((bsz, n, 4), torch.float32)
    ws_list = new((bsz, n), torch.int32)
    args = make_args(lay, masks, counts, cfg, phases)
    with torch.cuda.device(dev):
        err = _launcher()(
            ctypes.addressof(args), bsz, space.flat.data_ptr(), ws_lane.data_ptr(),
            ws_emit.data_ptr(), ws_list.data_ptr(), x.data_ptr(), y.data_ptr(),
            octave.data_ptr(), layer.data_ptr(), size.data_ptr(), pori.data_ptr(),
            desc.data_ptr(), valid.data_ptr(), extrema.data_ptr(), refined.data_ptr(),
            n_active.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "detect")
    profiling.count("detect.kernel_lanes", bsz * n)
    profiling.count("detect.kernel_launches", 1)
    kp = Keypoints(x=x, y=y, octave=octave, layer=layer, size=size, pori=pori, desc=desc,
                   valid=valid)
    return kp, dict(extrema=extrema, refined=refined, refine_active=n_active)
