"""Twin-block rows: the strip-interleaved gather space of per-octave
stacks, and the row-major rows of one or several volumes.

Kernels E and H are one kernel, ``twin_rows_launch`` in
``csrc/twin_rows.cu``: one launch writes a whole buffer from a table of
regions (``launch``).  The table is built here: ``strips_table`` for E,
``rows_table`` for H.  Every row of the buffer lies in exactly one region,
so the wrappers allocate with ``torch.empty``.  ``walk_plain`` is the
kernel's schedule in plain numpy, unit by unit, for the CPU tests.

``twin_rows_strips`` is the wrapper of kernel E, the port of the TPU kernel
``sift_tpu/ops/pallas_relayout.py::twin_rows_strips``: one launch writes
every octave's twin rows into one shared buffer, and the result is a
``gather.MultiRows``.  Its plain version is ``twin_rows_strips_plain``:
each octave's rows through pad, reshape and concatenation
(``twin_rows_plain``).

``twin_rows_2d_multi`` is the wrapper of kernel H, the port of
``pallas_relayout.py::twin_rows_2d``: the row-major twin rows of several
(R, W) matrices, one after another, in one launch
(``gather.build_multi_rows``); ``twin_rows_2d`` is its one-matrix case
(``gather.build_block_rows``).  Their plain versions are
``twin_rows_2d_multi_plain`` and ``twin_rows_2d_plain``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Pure data movement: the gathers read the same values as from
``gather.StackSpace``.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from sift_tpu_torch import kernels
from sift_tpu_torch.ops.gather import MultiRows

# csrc/twin_rows.cu: ROWS, TILE_FLOATS, MAX_REGIONS, MAX_BLK.
ROWS = 8
TILE_FLOATS = 12288
MAX_REGIONS = 64
MAX_BLK = 128


def pick_strip(r: int, nb: int, blk: int) -> int:
    """Rows per strip of an octave of ``r`` flat rows: the JAX package's
    choice (pallas_relayout._pick_strip), which fixes the layout."""
    st = 1024
    while st > 8 and (st * blk * 4 * (3 * nb + 1) > 8 * 1024 * 1024 or st >= 4 * max(8, r)):
        st //= 2
    return st


def plan(shapes, blk: int):
    """Per octave (S, H, W): (nb, log2 strip, padded rows, base row), and
    the buffer's row count.  Each base is a multiple of nb * strip."""
    metas, acc = [], 0
    for s, h, w in shapes:
        r = s * h
        nb = -(-w // blk)
        st = pick_strip(r, nb, blk)
        rpad = -(-r // st) * st
        unit = nb * st
        acc = -(-acc // unit) * unit
        metas.append((nb, st.bit_length() - 1, rpad, acc))
        acc += nb * rpad
    return metas, acc


class Region(NamedTuple):
    """One region of a twin-row buffer, as the kernel walks it: the rows
    ``base + (((r >> ls) * nb + b) << ls) + (r & (2**ls - 1))`` for r <
    rpad, b < nb, from flat row r of source ``src`` (an index into the
    launch's sources) of R rows and W columns, zero past R and W.  A gap
    has ``src`` -1 and R 0: rpad rows of zeros.  Work units take ROWS
    rows and ``nbc`` blocks, ``nchunks`` units across the blocks."""

    src: int
    R: int
    W: int
    nb: int
    ls: int
    rpad: int
    base: int
    nbc: int
    nchunks: int


def _region(src, r, w, nb, ls, rpad, base, blk) -> Region:
    most = TILE_FLOATS // (ROWS * blk) - 1  # blocks a staged tile holds
    nchunks = -(-nb // most)
    return Region(src, r, w, nb, ls, rpad, base, -(-nb // nchunks), nchunks)


def units(reg: Region) -> int:
    """Work units (CTAs per image) of a region."""
    return -(-reg.rpad // ROWS) * reg.nchunks


class Table(NamedTuple):
    """A launch table: the regions in buffer order (at most MAX_REGIONS),
    the buffer's rows, and the launcher's int array (per region R, W, nb,
    ls, rpad, base, nbc, nchunks and the running sum of units before it)
    with its address, and the kernel's name for its launch count
    (``twin_rows``: E, ``twin_rows_2d``: H)."""

    regions: tuple
    rows: int
    ints: np.ndarray
    addr: int
    kernel: str


def _table(regions, rows, kernel) -> Table:
    if len(regions) > MAX_REGIONS:
        raise ValueError(f"twin_rows: {len(regions)} regions, at most {MAX_REGIONS} a launch")
    first = np.cumsum([0] + [units(e) for e in regions])[:-1]
    ints = np.ascontiguousarray([list(e[1:]) + [int(f)] for e, f in zip(regions, first)],
                                dtype=np.int32)
    ints.flags.writeable = False  # shared by every call through the cached table
    return Table(tuple(regions), rows, ints, ints.ctypes.data, kernel)


@functools.lru_cache(maxsize=256)
def strips_table(shapes: tuple, blk: int) -> Table:
    """Kernel E's table for per-octave (S, H, W) shapes: each octave (source
    o) and the alignment gap before it, in buffer order."""
    metas, total = plan(shapes, blk)
    regions, end = [], 0
    for o, ((s, h, w), (nb, ls, rpad, base)) in enumerate(zip(shapes, metas)):
        if base > end:
            regions.append(_region(-1, 0, 0, 1, 0, base - end, end, blk))
        regions.append(_region(o, s * h, w, nb, ls, rpad, base, blk))
        end = base + nb * rpad
    return _table(regions, total, "twin_rows")


@functools.lru_cache(maxsize=256)
def rows_table(shapes: tuple, blk: int) -> Table:
    """Kernel H's table for sources of shapes (..., W), each read as its
    flat rows: row-major, one after another (the JAX package's
    ``build_multi_rows`` bases)."""
    regions, base = [], 0
    for i, shape in enumerate(shapes):
        r, w = math.prod(shape[:-1]), shape[-1]
        nb = -(-w // blk)
        regions.append(_region(i, r, w, nb, 0, r, base, blk))
        base += r * nb
    return _table(regions, base, "twin_rows_2d")


def walk_plain(table: Table, srcs, out) -> np.ndarray:
    """The kernel's schedule in plain numpy: every work unit of ``table``
    (found by the prefix of units, split as the kernel splits it) stages its
    rows and blocks, zero past R and W, and writes its twin rows into
    ``out`` (B, RT, 2 * blk), a CPU tensor.  ``srcs``: CPU tensors, each
    read as (B, R, W).  Returns how often each (image, row) was written."""
    o = out.numpy()
    bsz, _, twin = o.shape
    blk = twin // 2
    regions = table.regions
    first = np.cumsum([0] + [units(e) for e in regions])
    writes = np.zeros(o.shape[:2], np.int64)
    for u in range(int(first[-1])):
        i = bisect.bisect_right(first, u) - 1
        e = regions[i]
        g, ch = divmod(u - int(first[i]), e.nchunks)
        r0, b0 = g * ROWS, ch * e.nbc
        nbc = min(e.nbc, e.nb - b0)
        x0 = b0 * blk
        tile = np.zeros((bsz, ROWS, (nbc + 1) * blk), o.dtype)
        nr, n = min(ROWS, e.R - r0), min((nbc + 1) * blk, e.W - x0)
        if nr > 0 and n > 0:
            src = srcs[e.src].numpy().reshape(bsz, e.R, e.W)
            tile[:, :nr, :n] = src[:, r0: r0 + nr, x0: x0 + n]
        for tr in range(ROWS * nbc):
            j, bb = tr % ROWS, tr // ROWS
            r = r0 + j
            if r >= e.rpad:
                continue
            row = e.base + ((((r >> e.ls) * e.nb + b0 + bb) << e.ls) + (r & ((1 << e.ls) - 1)))
            o[:, row] = tile[:, j, bb * blk: (bb + 2) * blk]
            writes[:, row] += 1
    return writes


@functools.cache
def _launcher():
    fn = kernels.load("twin_rows").twin_rows_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, i, i, ctypes.c_longlong, p]
    fn.restype = i
    return fn


def launch(table: Table, srcs, out) -> None:
    """Kernel E / H: write ``table``'s regions from ``srcs`` (contiguous
    float32 tensors, each read as (B, R, W)) into ``out`` (B, RT, 2 * blk),
    a contiguous float32 buffer on the same card, in one launch on the
    current stream.  Only the regions' rows are written."""
    bsz, rt, twin = out.shape
    dev = out.device
    if (out.dtype != torch.float32 or dev.type != "cuda" or not out.is_contiguous()
            or twin % 2 or not 1 <= twin // 2 <= MAX_BLK or rt != table.rows):
        raise ValueError("twin_rows: out must be a contiguous (B, RT, 2 * blk) float32 CUDA "
                         "tensor, blk 1..128, RT the table's rows")
    ptrs = []
    for e in table.regions:
        if e.src < 0:
            ptrs.append(None)
            continue
        v = srcs[e.src]
        if (v.dtype != torch.float32 or not v.is_contiguous() or v.numel() != bsz * e.R * e.W
                or v.device != dev):
            raise ValueError(f"twin_rows: source {e.src} must be a contiguous float32 tensor "
                             f"of {bsz} x {e.R} x {e.W} values on {dev}")
        ptrs.append(v.data_ptr())
    n = len(ptrs)
    with torch.cuda.device(dev):
        err = _launcher()(table.addr, (ctypes.c_void_p * n)(*ptrs), n, out.data_ptr(), bsz,
                          twin // 2, rt, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, table.kernel)


def twin_rows_plain(f: torch.Tensor, blk: int, ls: int, rpad: int) -> torch.Tensor:
    """One octave's flat rows f (B, R, W) -> its (B, nb * rpad, 2 * blk)
    region of the buffer: twin rows, zero past W and past R, strips of
    1 << ls rows each holding its nb blocks back to back."""
    bsz, r, w = f.shape
    nb = -(-w // blk)
    st = 1 << ls
    p = torch.zeros((bsz, rpad, (nb + 1) * blk), dtype=f.dtype, device=f.device)
    p[:, :r, :w] = f
    a = p.reshape(bsz, rpad, nb + 1, blk)
    twin = torch.cat([a[:, :, :-1], a[:, :, 1:]], dim=-1)  # (B, rpad, nb, 2 blk)
    twin = twin.reshape(bsz, rpad // st, st, nb, 2 * blk).transpose(2, 3)
    return twin.reshape(bsz, nb * rpad, 2 * blk)


def _space(stacks, blk: int, rows: torch.Tensor, metas) -> MultiRows:
    return MultiRows(
        rows=rows, shapes=tuple(tuple(v.shape[1:]) for v in stacks), blk=blk,
        nbs=tuple(m[0] for m in metas), bases=tuple(m[3] for m in metas),
        shp=tuple(m[1] for m in metas),
    )


def twin_rows_strips_plain(stacks: list[torch.Tensor], blk: int = 64) -> MultiRows:
    """Per-octave (B, S, H_o, W_o) stacks -> their ``MultiRows`` gather
    space; rows between octaves (alignment gaps) are zero."""
    metas, total = plan(tuple(tuple(v.shape[1:]) for v in stacks), blk)
    rows = torch.zeros((stacks[0].shape[0], total, 2 * blk), dtype=stacks[0].dtype,
                       device=stacks[0].device)
    for v, (nb, ls, rpad, base) in zip(stacks, metas):
        f = v.reshape(v.shape[0], -1, v.shape[-1])
        rows[:, base: base + nb * rpad] = twin_rows_plain(f, blk, ls, rpad)
    return _space(stacks, blk, rows, metas)


def twin_rows_strips(stacks: list[torch.Tensor], blk: int = 64) -> MultiRows:
    """Same contract as ``twin_rows_strips_plain``; kernel E (one launch
    for the whole space) on CUDA tensors."""
    dev = stacks[0].device
    if dev.type == "cpu":
        return twin_rows_strips_plain(stacks, blk)
    if dev.type != "cuda":
        raise ValueError(f"twin_rows_strips: unsupported device {dev}")
    if any(v.dim() != 4 for v in stacks):
        raise ValueError("twin_rows_strips: stacks must be (B, S, H, W)")
    bsz = stacks[0].shape[0]
    shapes = tuple(tuple(v.shape[1:]) for v in stacks)
    table = strips_table(shapes, blk)
    rows = torch.empty((bsz, table.rows, 2 * blk), dtype=torch.float32, device=dev)
    launch(table, stacks, rows)
    return _space(stacks, blk, rows, plan(shapes, blk)[0])


def twin_rows_2d_plain(mat: torch.Tensor, blk: int) -> torch.Tensor:
    """(R, W) -> (R * nb, 2 * blk): row r * nb + b holds columns [b * blk,
    (b + 2) * blk) of row r, zero past W (strips of one row)."""
    return twin_rows_plain(mat[None], blk, 0, mat.shape[0])[0]


def twin_rows_2d_multi_plain(mats: list[torch.Tensor], blk: int):
    """Matrices (R_i, W_i), or tensors read as their flat rows (..., W_i) ->
    (rows (sum of R_i * nb_i, 2 * blk), bases): each one's
    ``twin_rows_2d_plain`` rows from row bases[i]."""
    parts = [twin_rows_2d_plain(m.reshape(-1, m.shape[-1]), blk) for m in mats]
    bases = tuple(int(b) for b in np.cumsum([0] + [p.shape[0] for p in parts])[:-1])
    return torch.cat(parts), bases


def twin_rows_2d_multi(mats: list[torch.Tensor], blk: int):
    """Same contract as ``twin_rows_2d_multi_plain``; kernel H (one launch
    for all of them) on CUDA tensors."""
    dev = mats[0].device
    if dev.type == "cpu":
        return twin_rows_2d_multi_plain(mats, blk)
    if dev.type != "cuda":
        raise ValueError(f"twin_rows_2d: unsupported device {dev}")
    table = rows_table(tuple(m.shape for m in mats), blk)
    rows = torch.empty((table.rows, 2 * blk), dtype=torch.float32, device=dev)
    launch(table, mats, rows[None])
    return rows, tuple(e.base for e in table.regions)


def twin_rows_2d(mat: torch.Tensor, blk: int) -> torch.Tensor:
    """Same contract as ``twin_rows_2d_plain``; kernel H on a CUDA tensor
    (``twin_rows_2d_multi`` of one matrix)."""
    if mat.device.type == "cpu":
        return twin_rows_2d_plain(mat, blk)
    if mat.dim() != 2:
        raise ValueError("twin_rows_2d: mat must be (R, W)")
    return twin_rows_2d_multi([mat], blk)[0]
