"""The row schedule of ``csrc/octave_front.cu`` (kernels A, C and F), in
plain PyTorch.

The CUDA kernel walks a column tile of one image down a tall row strip and
keeps only a rolling window of rows in shared memory.  This module holds
the geometry of that walk (``ring_plan``, ``batch_rows_for``,
``strip_rows_for``: the same numbers as the ``.cu``'s launcher) and ``octave_rolling_plain``, which
computes an octave row by row in exactly the kernel's order: rings as
tensors indexed by ``row % depth``, warm-up rows above and below the strip,
row numbers clamped to the image before they are mapped to a ring slot,
DoG rows held back until the mask's later layers exist.  Every ring slot is
tagged with the row it holds and every read checks the tag, so a ring that
is too shallow fails here, on the CPU.  The function is the executable
specification of the schedule: it equals ``octave_blur_plain`` /
``octave_front_plain`` bit for bit, and nothing on any route calls it.

Names: layer k = 1..n is blur k (radius ``radii[k - 1]``), gauss 0 is the
seed, DoG j = gauss j+1 - gauss j, mask layer z = 1..n-2 is DoG z's.
``ext[k]`` is the halo gauss k still needs around the tile: the radii of
the later blurs, plus 1 for the mask's 3x3x3 window.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.config import half_kernel_weight_sum
from sift_tpu_torch.utils.numerics import xdiv

# csrc/octave_front.cu: TILE_W, BATCH_ROWS, SM_COUNT,
# FILL_ROWS, MIN_STRIP, SMEM_LIMIT.
TILE_W = 128
BATCH_ROWS = 12
SM_COUNT = 132
FILL_ROWS = 16
MIN_STRIP = 32
SMEM_LIMIT = 232448


def layer_ext(radii, mask: bool) -> list[int]:
    """ext[k], k = 0..n: rows and columns of gauss k needed beyond the tile."""
    m = 1 if mask else 0
    return [m + sum(radii[k:]) for k in range(len(radii) + 1)]


def ring_plan(radii, mask: bool, batch_rows: int = BATCH_ROWS, tile_w: int = TILE_W):
    """Depth (rows) and pitch (floats) of every shared-memory ring, and the
    bytes they take together.  ``h[k]``: horizontal pass of layer k,
    2 r_k + batch rows (the vertical pass of a batch reads that span);
    ``g[k]``: gauss k, kept r_{k+1} + batch rows until DoG k's later operand
    arrives; ``d[j]`` (mask only): DoG j, kept until mask layer j+1 has
    DoG j+2, r_{j+2} + r_{j+3} + batch + 2 rows."""
    n = len(radii)
    ext = layer_ext(radii, mask)
    r = lambda k: radii[k - 1] if 1 <= k <= n else 0  # noqa: E731
    plan = dict(
        ext=ext,
        h={k: (2 * r(k) + batch_rows, tile_w + 2 * ext[k]) for k in range(1, n + 1)},
        g={k: (r(k + 1) + batch_rows, tile_w + 2 * ext[k]) for k in range(n)},
        d={j: (r(j + 2) + r(j + 3) + batch_rows + 2, tile_w + 2) for j in range(n)} if mask else {},
    )
    plan["bytes"] = 4 * sum(d * p for ring in ("h", "g", "d") for d, p in plan[ring].values())
    return plan


def batch_rows_for(radii, mask: bool) -> int:
    """Rows per step, the launcher's rule: the largest batch up to BATCH_ROWS
    whose rings (and 256 bytes of padding) fit a CTA's shared memory; 0 if
    not even one row does (the launcher then refuses the chain)."""
    for batch in range(BATCH_ROWS, 0, -1):
        if ring_plan(radii, mask, batch)["bytes"] + 256 <= SMEM_LIMIT:
            return batch
    return 0


def strip_rows_for(bsz: int, h: int, w: int, halo: int, tile_w: int = TILE_W,
                   slots: int = SM_COUNT) -> int:
    """Rows of a CTA's strip, the launcher's rule: of the strip counts whose
    strips are at least MIN_STRIP rows, the one with the least estimated
    time, (waves of CTAs over ``slots``, the CTAs the card holds at once:
    one an SM here) x (rows a CTA walks: its strip, the warm-up rows on
    both sides and the pipeline's fill); the smaller count on a tie.
    Kernel D (csrc/blur_pass.cu) uses the same rule with its own tile and
    slots."""
    tiles = -(-w // tile_w) * bsz
    best = None
    for ns in range(1, max(1, h // MIN_STRIP) + 1):
        rows = -(-h // ns)
        cost = -(-tiles * ns // slots) * (rows + 2 * halo + FILL_ROWS)
        if best is None or cost < best[0]:
            best = (cost, rows)
    return best[1]


def row_ranges(ys: int, ye: int, h: int, ext) -> list[tuple[int, int]]:
    """[lo_k, hi_k): the rows of gauss k a strip [ys, ye) computes."""
    return [(max(0, ys - e), min(h, ye + e)) for e in ext]


class _Ring:
    """(B, depth, width) rows addressed by ``row % depth``, each slot tagged
    with the row it holds."""

    def __init__(self, like: torch.Tensor, depth: int, width: int):
        self.buf = like.new_full((like.shape[0], depth, width), float("nan"))
        self.tag = [None] * depth

    def put(self, row: int, value: torch.Tensor):
        s = row % len(self.tag)
        self.buf[:, s] = value
        self.tag[s] = row

    def get(self, row: int) -> torch.Tensor:
        s = row % len(self.tag)
        assert self.tag[s] == row, f"ring slot {s} holds row {self.tag[s]}, wanted {row}"
        return self.buf[:, s]


def _walk_tile(seed, out, taps, sums, radii, threshold, ys, ye, x0, x1, batch_rows, tile_w):
    """One CTA: the column tile [x0, x1) of every image over rows [ys, ye)."""
    gauss, dogs, mask, counts = out
    _, h, w = seed.shape
    n = len(radii)
    with_mask = mask is not None
    plan = ring_plan(radii, with_mask, batch_rows, tile_w)
    ext = plan["ext"]
    tw = x1 - x0
    rng = row_ranges(ys, ye, h, ext)
    hring = {k: _Ring(seed, plan["h"][k][0], tw + 2 * ext[k]) for k in plan["h"]}
    gring = {k: _Ring(seed, plan["g"][k][0], tw + 2 * ext[k]) for k in plan["g"]}
    dring = {j: _Ring(seed, plan["d"][j][0], tw + 2) for j in plan["d"]}
    # Columns of gauss k in image coordinates, clamped: a column outside the
    # image holds its border column's value, so no tap clamps in x.
    cols = [torch.arange(x0 - e, x1 + e).clamp(0, w - 1) for e in ext]

    def seed_row(y):
        gring[0].put(y, seed[:, y, cols[0]])
        if ys <= y < ye:
            gauss[:, 0, y, x0:x1] = seed[:, y, x0:x1]

    def hpass(k, y):
        src = gring[k - 1].get(y)
        at = cols[k] - (x0 - ext[k - 1])  # clamped column -> index in gauss k-1's ring
        acc = src[:, at] * taps[k][0]
        for u in range(1, radii[k - 1] + 1):
            acc = acc + taps[k][u] * (src[:, at + u] + src[:, at - u])
        hring[k].put(y, xdiv(acc, sums[k]))

    def vpass(k, y):
        acc = hring[k].get(y) * taps[k][0]
        for u in range(1, radii[k - 1] + 1):  # clamp the row first, map to a slot second
            acc = acc + taps[k][u] * (hring[k].get(min(y + u, h - 1)) + hring[k].get(max(y - u, 0)))
        g = xdiv(acc, sums[k])
        if k < n:
            gring[k].put(y, g)
        e = ext[k]
        shift = ext[k - 1] - e
        d = g - gring[k - 1].get(y)[:, shift: shift + tw + 2 * e]
        if ys <= y < ye:
            gauss[:, k, y, x0:x1] = g[:, e: e + tw]
            dogs[:, k - 1, y, x0:x1] = d[:, e: e + tw]
        if with_mask:
            dring[k - 1].put(y, d[:, e - 1: e + tw + 1])

    def mask_row(z, y):
        m = torch.zeros((seed.shape[0], tile_w), dtype=torch.bool)
        if 1 <= y <= h - 2:
            rows = torch.stack([dring[j].get(yy) for j in (z - 1, z, z + 1)
                                for yy in (y - 1, y, y + 1)], dim=1)  # (B, 9, tw + 2)
            win = torch.stack([rows[:, :, dx: dx + tw] for dx in range(3)], dim=1).flatten(1, 2)
            c = dring[z].get(y)[:, 1: tw + 1]
            x = torch.arange(x0, x1)
            ok = (x >= 1) & (x <= w - 2)
            m[:, :tw] = ok & (c.abs() > threshold) & ((c >= win.amax(1)) | (c <= win.amin(1)))
        mask[:, z - 1, y, x0: x0 + tile_w] = m.to(mask.dtype)
        counts[:, z - 1, y, x0 // tile_w] = m.sum(1, dtype=torch.int32)

    g_next = [lo for lo, _ in rng]          # next row of gauss k to produce
    m_next = {z: ys for z in range(1, n - 1)} if with_mask else {}
    while True:
        # Sub-phase 0: mask rows whose three DoG layers exist, then a batch
        # of seed rows, each with layer 1's horizontal pass.
        for z in m_next:
            lim = ye if g_next[z + 2] == rng[z + 2][1] else min(ye, g_next[z + 2] - 1)
            for y in range(m_next[z], min(m_next[z] + batch_rows, lim)):
                mask_row(z, y)
                m_next[z] = y + 1
        if g_next[n] == rng[n][1] and all(v == ye for v in m_next.values()):
            return
        for y in range(g_next[0], min(g_next[0] + batch_rows, rng[0][1])):
            seed_row(y)
            hpass(1, y)
            g_next[0] = y + 1
        # Sub-phase k: the rows of gauss k whose taps exist (at most a
        # batch), each followed by layer k+1's horizontal pass of that row.
        for k in range(1, n + 1):
            lim = rng[k][1] if g_next[k - 1] == rng[k - 1][1] else g_next[k - 1] - radii[k - 1]
            for y in range(g_next[k], min(g_next[k] + batch_rows, lim, rng[k][1])):
                vpass(k, y)
                if k < n:
                    hpass(k + 1, y)
                g_next[k] = y + 1


def octave_rolling_plain(seed: torch.Tensor, half_kernels, strip_rows: int,
                         batch_rows: int = BATCH_ROWS, threshold: float | None = None,
                         tile_w: int = TILE_W):
    """seed ([B,] H, W) -> (gauss, dogs) as ``octave_blur_plain`` or, with a
    ``threshold``, (gauss, dogs, mask, counts) as ``octave_front_plain``,
    computed tile by tile and strip by strip in the CUDA kernel's rolling
    row schedule."""
    batched = seed.dim() == 3
    if not batched:
        seed = seed[None]
    bsz, h, w = seed.shape
    n = len(half_kernels)
    radii = [len(hk) - 1 for hk in half_kernels]
    taps = {k: list(half_kernels[k - 1]) for k in range(1, n + 1)}
    sums = {k: half_kernel_weight_sum(list(half_kernels[k - 1])) for k in range(1, n + 1)}
    nan = float("nan")
    gauss = seed.new_full((bsz, n + 1, h, w), nan)
    dogs = seed.new_full((bsz, n, h, w), nan)
    mask = counts = None
    if threshold is not None:
        nbm = -(-w // tile_w)
        mask = seed.new_full((bsz, n - 2, h, nbm * tile_w), nan)
        counts = torch.full((bsz, n - 2, h, nbm), -1, dtype=torch.int32)
    for ys in range(0, h, strip_rows):
        for x0 in range(0, w, tile_w):
            _walk_tile(seed, (gauss, dogs, mask, counts), taps, sums, radii, threshold,
                       ys, min(ys + strip_rows, h), x0, min(x0 + tile_w, w), batch_rows, tile_w)
    outs = (gauss, dogs) if threshold is None else (gauss, dogs, mask, counts)
    return outs if batched else tuple(o[0] for o in outs)
