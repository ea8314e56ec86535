"""Mask compaction, tiny-table lookups and the gather spaces.

A gather space holds the per-octave (B, S, H_o, W_o) stacks of a batch in
one buffer, so one gather serves every octave; cubes and patches are then
one element gather each.  Two layouts:

* ``StackSpace``: the plain stacks, flattened one after another;
* ``MultiRows``: the strip-interleaved twin-block rows that kernel E
  (ops/twin_rows.py) writes, the JAX package's ``gather.MultiRows`` with
  ``shp`` set.  The JAX package's non-front route builds it on the
  accelerator in float32, and so does the port's on the card.

Both answer ``index(img, oct_id, s, y, x, x0)``: the flat offset of element
(s, y, x) of each lane's volume.  ``x0`` is the lane's window start, which
picks the twin block as the JAX package's gathers pick it.  The JAX
package's other TPU layouts (row units, cube-packed DoG rows, the front
kernel's emission) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


def compact_mask(flat: torch.Tensor, cap: int):
    """Ascending indices of the first ``cap`` True lanes of ``flat`` (lanes
    last, any leading batch dims): ``(idx, valid)`` with ``idx`` int64 in
    [0, n-1] and ``valid[k]`` iff there are more than ``k`` set lanes."""
    n = flat.shape[-1]
    idx = torch.sort((~flat).to(torch.uint8), dim=-1, stable=True).indices[..., :cap]
    if cap > n:  # a capacity above the lane count: the tail is never valid
        idx = torch.cat([idx, idx.new_full(idx.shape[:-1] + (cap - n,), n - 1)], dim=-1)
    total = flat.sum(-1, keepdim=True)
    valid = torch.arange(cap, device=flat.device) < total
    return torch.where(valid, idx, torch.full_like(idx, n - 1)), valid


def padded_chunks(n: int, chunk: int, device):
    """Lane indices ``[0, n)`` padded to a whole number of ``chunk``-lane
    chunks (the last lane repeated), and the chunks' slices.

    Orientation and descriptors contract each chunk with one batched
    matmul.  cuBLAS picks its kernel, and with it the order of the sums, by
    the batch size, so a lane's result would depend on how many lanes its
    call has; equal chunks keep it the same on every path.
    """
    n_pad = -(-n // chunk) * chunk
    idx = torch.arange(n_pad, device=device).clamp_max(max(n - 1, 0))
    return idx, [slice(i, i + chunk) for i in range(0, n_pad, chunk)]


def lut(values, sel: torch.Tensor, dtype) -> torch.Tensor:
    """Per-lane lookup of a tiny static table: out[i] = values[sel[i]]."""
    table = torch.tensor(values, dtype=dtype, device=sel.device)
    return table[sel.long()]


class _Space:
    shapes: tuple  # (S, H, W) per octave

    def lut(self, name: str, values, oct_id: torch.Tensor) -> torch.Tensor:
        """``lut`` over a per-octave int64 table kept on the lanes' device
        for the life of the space: building a device table from host data
        waits for the stream, and the gathers run once per Newton step and
        per lane chunk."""
        tables = self.__dict__.setdefault("_tables", {})
        t = tables.get(name)
        if t is None:
            t = tables[name] = torch.tensor(values, dtype=torch.int64, device=oct_id.device)
        return t[oct_id.long()]

    def table(self, axis: int, oct_id: torch.Tensor) -> torch.Tensor:
        """Per-lane octave dimension (0: S, 1: H, 2: W), int64."""
        return self.lut(f"dim{axis}", [s[axis] for s in self.shapes], oct_id)


@dataclasses.dataclass
class StackSpace(_Space):
    """Per-octave (B, S, H_o, W_o) stacks flattened into one buffer.

    ``flat`` is (B * total,): image ``b``'s octave ``o`` starts at
    ``b * total + bases[o]``, its element (s, y, x) sits at
    ``(s * H_o + y) * W_o + x`` from there.
    """

    flat: torch.Tensor
    shapes: tuple
    bases: tuple
    total: int

    @staticmethod
    def build(stacks: list[torch.Tensor]) -> "StackSpace":
        b = stacks[0].shape[0]
        parts = [s.reshape(b, -1) for s in stacks]
        bases, acc = [], 0
        for p in parts:
            bases.append(acc)
            acc += p.shape[1]
        return StackSpace(
            flat=torch.cat(parts, dim=1).reshape(-1),
            shapes=tuple(tuple(s.shape[1:]) for s in stacks),
            bases=tuple(bases),
            total=acc,
        )

    def index(self, img, oct_id, s, y, x, x0):
        origin = img.long() * self.total + self.lut("bases", self.bases, oct_id)
        return origin + (s * self.table(1, oct_id) + y) * self.table(2, oct_id) + x


@dataclasses.dataclass
class MultiRows(_Space):
    """Strip-interleaved twin-block rows of per-octave stacks.

    ``rows`` is (B, RT, 2 * blk).  With r = s * H_o + y the flat image row,
    octave ``o``'s row (s, y), block b (columns [b * blk, (b + 2) * blk),
    zero past W_o) is row ``bases[o] + (((r >> ls) * nbs[o] + b) << ls) +
    (r & (st - 1))`` of each image, ls = shp[o] and st = 1 << ls.  Any
    window of up to blk + 1 columns from x0 lies in block x0 // blk.
    """

    rows: torch.Tensor
    shapes: tuple
    blk: int
    nbs: tuple
    bases: tuple
    shp: tuple

    @property
    def flat(self) -> torch.Tensor:
        return self.rows.reshape(-1)

    def index(self, img, oct_id, s, y, x, x0):
        nb = self.lut("nbs", self.nbs, oct_id)
        ls = self.lut("shp", self.shp, oct_id)
        # The block of the window start, as the JAX package's gathers pick
        # it; a column past that twin (a window wider than blk + 1) takes
        # the block that holds it in its second half.
        b = torch.maximum(torch.minimum(x0.long().clamp_min(0) // self.blk, nb - 1),
                          x // self.blk - 1)
        r = s * self.table(1, oct_id) + y
        row = (
            img.long() * self.rows.shape[1] + self.lut("bases", self.bases, oct_id)
            + (((r >> ls) * nb + b) << ls) + (r & ((1 << ls) - 1))
        )
        return row * (2 * self.blk) + x - b * self.blk


def gather_cubes(sp, img, oct_id, zyx) -> torch.Tensor:
    """(..., 3, 3, 3) cubes cube[a, b, c] = vol[z+a-1, y+b-1, x+c-1] from a
    gather space.

    Positions are clamped to the interior for the read only: valid lanes
    always are interior, and invalid lanes' values are never used.
    """
    h = sp.table(1, oct_id)
    w = sp.table(2, oct_id)
    s = sp.table(0, oct_id)
    z = torch.minimum(zyx[..., 0].long().clamp_min(1), s - 2)
    y = torch.minimum(zyx[..., 1].long().clamp_min(1), h - 2)
    x = torch.minimum(zyx[..., 2].long().clamp_min(1), w - 2)
    d = torch.arange(-1, 2, device=zyx.device)
    e = (..., None, None, None)
    return sp.flat[sp.index(
        img[e], oct_id[e], z[e] + d[:, None, None], y[e] + d[None, :, None],
        x[e] + d[None, None, :], x[e] - 1,
    )]


def gather_patches(sp, img, oct_id, layer, ys0, xs0, patch: int):
    """(N, patch, patch) patches p[n, a, b] = vol[layer, ys0 + a, xs0 + b]
    from a gather space, with rows and columns clamped to the image
    (callers mask every sample whose gradient neighbourhood leaves the
    image, as the reference does)."""
    h = sp.table(1, oct_id)[:, None]
    w = sp.table(2, oct_id)[:, None]
    aa = torch.arange(patch, device=ys0.device)
    ys = torch.minimum((ys0.long()[:, None] + aa).clamp_min(0), h - 1)
    xs = torch.minimum((xs0.long()[:, None] + aa).clamp_min(0), w - 1)
    e = (slice(None), None, None)
    return sp.flat[sp.index(
        img[e], oct_id[e], layer.long()[e], ys[:, :, None], xs[:, None, :], xs0[e],
    )]
