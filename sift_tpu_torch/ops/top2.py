"""Exact-integer top-2 of squared L2 descriptor distances.

``top2`` is the wrapper of kernel B (``csrc/top2.cu``), the port of the TPU
kernel ``sift_tpu/ops/pallas_match.py::pallas_top2``; ``top2_plain`` is its
plain PyTorch version: a d^2 matrix from one matmul (float64 on the CPU,
float32 with TF32 off on the card -- exact either way, every partial sum is
an integer below 2^24), then argmin and a masked min.

``top2_tiled_plain`` is the kernel's scan in plain PyTorch: the column
splits of a cluster, the 128-column tiles, the 8-column fragments and the
two columns of each a lane sees, each lane's running top-2 in ascending
column order, the merge of a quad's four lanes and of the splits.  It
equals ``top2_plain`` bit for bit, and nothing on any route calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sift_tpu_torch import kernels

# Larger than any squared distance (< 2^23) with 16 * HUGE inside int32.
HUGE_D2 = 1 << 24
# csrc/top2.cu: INVALID_NORM, ROWS, TILE, MAX_SPLIT, SM_COUNT, CTAS_PER_SM.
INVALID_NORM = 1 << 26
ROWS = 64
TILE = 128
MAX_SPLIT = 8
SM_COUNT = 132
CTAS_PER_SM = 2


def top2_plain(desc1, desc2, valid2):
    """desc1 (P, N, 128) u8, desc2 (P, M, 128) u8, valid2 (P, M) bool ->
    (best, second, idx) int32 (P, N).  First column wins ties; duplicates of
    the best count as second; invalid columns read HUGE_D2."""
    dt = torch.float64 if desc1.device.type == "cpu" else torch.float32
    a = desc1.to(dt)
    b = desc2.to(dt)
    g = a @ b.transpose(-1, -2)
    na = (a * a).sum(-1)
    nb = (b * b).sum(-1)
    d2 = (na[..., :, None] + nb[..., None, :] - 2.0 * g).to(torch.int32)
    d2 = torch.where(valid2[..., None, :].bool(), d2, HUGE_D2)
    idx = torch.argmin(d2, dim=-1)
    best = torch.gather(d2, -1, idx[..., None])[..., 0]
    cols = torch.arange(d2.shape[-1], device=d2.device)
    second = torch.where(cols == idx[..., None], HUGE_D2, d2).amin(-1)
    return best, second, idx.to(torch.int32)


def top2(desc1, desc2, valid2):
    """Same contract as ``top2_plain``; kernel B on CUDA tensors."""
    if desc1.device.type == "cpu":
        return top2_plain(desc1, desc2, valid2)
    if desc1.device.type != "cuda":
        raise ValueError(f"top2: unsupported device {desc1.device}")
    for t, name in ((desc1, "desc1"), (desc2, "desc2")):
        if t.dtype != torch.uint8 or t.dim() != 3 or t.shape[-1] != 128:
            raise ValueError(f"top2: {name} must be (P, n, 128) uint8")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"top2: {name} must be contiguous and 16-byte aligned")
        if t.device != desc1.device:
            raise ValueError("top2: inputs on different devices")
    pn, n = desc1.shape[:2]
    m = desc2.shape[1]
    if desc2.shape[0] != pn or tuple(valid2.shape) != (pn, m):
        raise ValueError("top2: shapes disagree")
    if valid2.dtype not in (torch.bool, torch.uint8) or valid2.device != desc1.device:
        raise ValueError("top2: valid2 must be bool/uint8 on the same device")
    valid2 = valid2.contiguous()
    out = [torch.empty((pn, n), dtype=torch.int32, device=desc1.device) for _ in range(3)]
    with torch.cuda.device(desc1.device):
        stream = torch.cuda.current_stream(desc1.device).cuda_stream
        err = _launcher()(
            desc1.data_ptr(), desc2.data_ptr(), valid2.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            pn, n, m, stream,
        )
    kernels.check(err, "top2")
    return tuple(out)


@functools.cache
def _launcher():
    fn = kernels.load("top2").top2_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, p]
    fn.restype = i
    return fn


def split_for(p: int, n: int, m: int) -> tuple[int, int]:
    """(splits, tiles per split) of the columns, the launcher's rule: enough
    CTAs for CTAS_PER_SM an SM, at most MAX_SPLIT and no more than the
    tiles; then as few splits as give the same tiles per split."""
    ntiles = -(-m // TILE)
    s = min(MAX_SPLIT, max(1, -(-SM_COUNT * CTAS_PER_SM // (-(-n // ROWS) * p))))
    if s > ntiles:
        s = max(1, ntiles)
    tps = -(-ntiles // s) if ntiles else 0
    return (-(-ntiles // tps) if tps else 1), tps


def _merge(a, b):
    """Two partial top-2 states (b1, i1, b2): the lexicographic minimum of
    (b1, i1) wins; the second is the least of the loser's b1 and both b2."""
    a_wins = (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))
    return (torch.where(a_wins, a[0], b[0]), torch.where(a_wins, a[1], b[1]),
            torch.minimum(torch.minimum(a[2], b[2]), torch.where(a_wins, b[0], a[0])))


def top2_tiled_plain(desc1, desc2, valid2, splits: tuple[int, int] | None = None):
    """Same contract as ``top2_plain``, computed in kernel B's scan order.
    ``splits`` = (splits, tiles per split) defaults to the launcher's
    rule.  Rows are independent, so the CTA's 64 rows and its warps' 16
    change nothing here; what the order can change is within a row: which
    columns a lane sees, in which order, and how the partials merge."""
    pn, n = desc1.shape[:2]
    m = desc2.shape[1]
    a = desc1.to(torch.float64)
    b = desc2.to(torch.float64)
    dot = (a @ b.transpose(-1, -2)).to(torch.int64)
    na = (a * a).sum(-1).to(torch.int64)
    nb = torch.where(valid2.bool(), (b * b).sum(-1).to(torch.int64), INVALID_NORM)
    # The kernel compares |b|^2 - 2 a.b and adds the row's |a|^2 back after
    # the scan; an invalid target (INVALID_NORM) never enters.
    d = nb[..., None, :] - 2 * dot
    nsplit, tps = splits or split_for(pn, n, m)
    ntiles = -(-m // TILE)
    # Columns past M are zero rows with INVALID_NORM.
    d = torch.cat([d, torch.full((pn, n, ntiles * TILE - m), INVALID_NORM, dtype=torch.int64)], -1)
    huge = HUGE_D2 - na
    zero = torch.zeros((pn, n), dtype=torch.int64)
    parts = []
    for s in range(nsplit):
        cols = range(s * tps * TILE, min((s + 1) * tps, ntiles) * TILE)
        lanes = []
        for t in range(4):  # the quad's lanes: columns 2t, 2t+1 of each fragment
            b1, i1, b2 = huge, zero, huge
            for f0 in range(cols.start, cols.stop, 8):
                for j in (f0 + 2 * t, f0 + 2 * t + 1):
                    lt = d[..., j] < b1
                    b2 = torch.where(lt, b1, torch.minimum(b2, d[..., j]))
                    i1 = torch.where(lt, j, i1)
                    b1 = torch.where(lt, d[..., j], b1)
            lanes.append((b1, i1, b2))
        b1, i1, b2 = _merge(_merge(lanes[0], lanes[1]), _merge(lanes[2], lanes[3]))
        parts.append((b1 + na, i1, b2 + na))
    out = parts[0]
    for part in parts[1:]:
        out = _merge(out, part)
    return tuple(x.to(torch.int32) for x in (out[0], out[2], out[1]))
