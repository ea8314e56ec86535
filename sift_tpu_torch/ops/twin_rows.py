"""Twin-block rows: the strip-interleaved gather space of per-octave
stacks, and the row-major rows of one volume.

``twin_rows_strips`` is the wrapper of kernel E (``csrc/twin_rows.cu``),
the port of the TPU kernel ``sift_tpu/ops/pallas_relayout.py::
twin_rows_strips``: one launch per octave writes that octave's twin rows
into one shared buffer, and the result is a ``gather.MultiRows``.  Its
plain version is ``twin_rows_strips_plain``: each octave's rows through
pad, reshape and concatenation (``twin_rows_plain``).

``twin_rows_2d`` is the wrapper of kernel H (``twin_rows_2d_launch`` in the
same source), the port of ``pallas_relayout.py::twin_rows_2d``: the
row-major twin rows of one (R, W) matrix, which ``gather.build_block_rows``
builds a float32 volume's rows with.  Its plain version is
``twin_rows_2d_plain``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Pure data movement: the gathers read the same values as from
``gather.StackSpace``.
"""

from __future__ import annotations

import ctypes

import torch

from sift_tpu_torch import kernels
from sift_tpu_torch.ops.gather import MultiRows

MAX_BLK = 128  # csrc/twin_rows.cu: 2 * blk * ROWS threads per CTA


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


def _space(stacks, blk: int):
    """(empty MultiRows with zero rows, per-octave plan)."""
    shapes = tuple(tuple(v.shape[1:]) for v in stacks)
    metas, total = plan(shapes, blk)
    rows = torch.zeros((stacks[0].shape[0], total, 2 * blk), dtype=stacks[0].dtype,
                       device=stacks[0].device)
    return MultiRows(
        rows=rows, shapes=shapes, blk=blk,
        nbs=tuple(m[0] for m in metas), bases=tuple(m[3] for m in metas),
        shp=tuple(m[1] for m in metas),
    ), metas


def twin_rows_strips_plain(stacks: list[torch.Tensor], blk: int = 64) -> MultiRows:
    """Per-octave (B, S, H_o, W_o) stacks -> their ``MultiRows`` gather
    space; rows between octaves (alignment gaps) are zero."""
    mr, metas = _space(stacks, blk)
    for v, (nb, ls, rpad, base) in zip(stacks, metas):
        f = v.reshape(v.shape[0], -1, v.shape[-1])
        mr.rows[:, base: base + nb * rpad] = twin_rows_plain(f, blk, ls, rpad)
    return mr


def twin_rows_strips(stacks: list[torch.Tensor], blk: int = 64) -> MultiRows:
    """Same contract as ``twin_rows_strips_plain``; kernel E (one launch
    per octave) on CUDA tensors.  ``launches`` counts kernel launches."""
    dev = stacks[0].device
    if dev.type == "cpu":
        return twin_rows_strips_plain(stacks, blk)
    if dev.type != "cuda":
        raise ValueError(f"twin_rows_strips: unsupported device {dev}")
    if not 1 <= blk <= MAX_BLK:
        raise ValueError("twin_rows_strips: blk must be 1..128")
    for v in stacks:
        if v.dtype != torch.float32 or v.dim() != 4 or not v.is_contiguous():
            raise ValueError("twin_rows_strips: stacks must be contiguous (B, S, H, W) float32")
    mr, metas = _space(stacks, blk)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for v, (_, ls, _, base) in zip(stacks, metas):
            err = fn(v.data_ptr(), mr.rows.data_ptr(), v.shape[0], v.shape[1] * v.shape[2],
                     v.shape[3], blk, ls, mr.rows.shape[1], base, stream)
            kernels.check(err, "twin_rows")
            twin_rows_strips.launches += 1
    return mr


twin_rows_strips.launches = 0


def twin_rows_2d_plain(mat: torch.Tensor, blk: int) -> torch.Tensor:
    """(R, W) -> (R * nb, 2 * blk): row r * nb + b holds columns [b * blk,
    (b + 2) * blk) of row r, zero past W (strips of one row)."""
    return twin_rows_plain(mat[None], blk, 0, mat.shape[0])[0]


def twin_rows_2d(mat: torch.Tensor, blk: int) -> torch.Tensor:
    """Same contract as ``twin_rows_2d_plain``; kernel H on a CUDA tensor."""
    if mat.device.type == "cpu":
        return twin_rows_2d_plain(mat, blk)
    if mat.device.type != "cuda":
        raise ValueError(f"twin_rows_2d: unsupported device {mat.device}")
    if not 1 <= blk <= MAX_BLK:
        raise ValueError("twin_rows_2d: blk must be 1..128")
    if mat.dtype != torch.float32 or mat.dim() != 2 or not mat.is_contiguous():
        raise ValueError("twin_rows_2d: mat must be a contiguous (R, W) float32 tensor")
    r, w = mat.shape
    out = torch.empty((r * -(-w // blk), 2 * blk), dtype=torch.float32, device=mat.device)
    fn = kernels.load("twin_rows").twin_rows_2d_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, p]
    fn.restype = i
    with torch.cuda.device(mat.device):
        err = fn(mat.data_ptr(), out.data_ptr(), r, w, blk,
                 torch.cuda.current_stream(mat.device).cuda_stream)
    kernels.check(err, "twin_rows_2d")
    twin_rows_2d.launches += 1
    return out


twin_rows_2d.launches = 0


def _launcher():
    fn = kernels.load("twin_rows").twin_rows_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, i, i, i, i, i, ll, ll, p]
    fn.restype = i
    return fn
