"""Mask compaction, tiny-table lookups and the gather spaces.

A gather space holds the per-octave (S, H_o, W_o) volumes of a batch in one
buffer, so one gather serves every octave; cubes and patches are then one
element gather each.  The layouts, each the counterpart of one in the JAX
package's ``ops/gather.py``:

* ``StackSpace``: the plain stacks, flattened one after another;
* ``BlockRows``: row-major twin-block rows of one (S, H, W) volume
  (``build_block_rows``; the staged path's DoG space);
* ``MultiRows``: twin-block rows of several volumes in one of three row
  orders: row-major (``build_multi_rows``; the staged path's gauss space),
  strip-interleaved (kernel E, ops/twin_rows.py; the non-front route) or
  strip-major / layer-minor holding only some layers (kernel F,
  ops/octave_front.py; the front-twin route's gauss space);
* ``CubeRows``: cube-packed DoG rows, every layer of a window of ``sw``
  columns in one 128-lane row (kernels F and G; the front-twin route's DoG
  space).

All answer ``index(img, oct_id, s, y, x, x0)``: the flat offset into
``flat`` of element (s, y, x) of each lane's volume.  ``x0`` is the lane's
window start, which picks the twin (or packed) block as the JAX package's
gathers pick it.  Every layout is pure data movement: a gather reads the
same values from each.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.numerics import device_const


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


def radius_classes(candidates, r_max: int) -> list[int]:
    """A stage's window radii, ascending: the candidates below ``r_max``,
    then ``r_max`` (the JAX package's dispatch classes)."""
    return [r for r in candidates if r < r_max] + [r_max]


def class_of(radius: torch.Tensor, radii) -> torch.Tensor:
    """Each lane's class: the index of the smallest of ``radii`` that covers
    its radius (``searchsorted``), the last class above them all."""
    t = device_const(radii, radius.dtype, radius.device)
    return torch.searchsorted(t, radius).clamp_max(len(radii) - 1)


def by_radius_class(radius: torch.Tensor, radii, chunk: int, args, fn,
                    stage: str | None = None) -> torch.Tensor:
    """``fn(lane args, r)`` over L >= 1 lanes, each lane in the window of its
    own class (``class_of``), results in lane order.

    A window wider than a lane's radius adds only masked exact zeros, so the
    class moves a lane's sums by their order alone, and it depends on the
    lane alone: every route and the staged path give a lane the same
    window.  The lanes are sorted stably by class, the per-class counts
    read to the host at once, and each class runs in ``padded_chunks`` of a
    fixed lane count (``chunk`` at the largest window, more lanes to a
    smaller one at about the same number of samples).

    ``stage``: while a profiler records, count the window samples of the
    valid lanes (``<stage>.samples_valid``) and of the lanes computed, the
    padding included (``<stage>.samples_computed``)."""
    cls = class_of(radius, radii)
    order = torch.argsort(cls, stable=True)
    with profiling.span("sift.sync.classes"):
        counts = torch.bincount(cls, minlength=len(radii)).tolist()
    side = 2 * radii[-1] + 1
    parts, start = [], 0
    for r, c in zip(radii, counts):
        if c:
            lanes = chunk * max(1, side * side // (2 * r + 1) ** 2)
            pad, chunks = padded_chunks(c, lanes, radius.device)
            if stage is not None:
                profiling.count(f"{stage}.samples_valid", c * (2 * r + 1) ** 2)
                profiling.count(f"{stage}.samples_computed", len(pad) * (2 * r + 1) ** 2)
            sel = order[start:start + c][pad]
            sub = [a[sel] for a in args]
            parts.append(torch.cat([fn([a[s] for a in sub], r) for s in chunks])[:c])
        start += c
    sorted_out = torch.cat(parts)
    out = torch.empty_like(sorted_out)
    out[order] = sorted_out
    return out


def lut(values, sel: torch.Tensor, dtype) -> torch.Tensor:
    """Per-lane lookup of a tiny static table: out[i] = values[sel[i]]."""
    return device_const(values, dtype, sel.device)[sel.long()]


class _Space:
    shapes: tuple  # (S, H, W) per octave

    def table(self, axis: int, oct_id: torch.Tensor) -> torch.Tensor:
        """Per-lane octave dimension (0: S, 1: H, 2: W), int64."""
        return lut([s[axis] for s in self.shapes], oct_id, torch.int64)


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
        origin = img.long() * self.total + lut(self.bases, oct_id, torch.int64)
        return origin + (s * self.table(1, oct_id) + y) * self.table(2, oct_id) + x


def _twin_block(x0, x, blk: int, nb):
    """The twin block of a window starting at column ``x0``, as the JAX
    package's gathers pick it; a column past that twin (a window wider than
    blk + 1) takes the block that holds it in its second half."""
    return torch.maximum(torch.clamp(x0.long().clamp_min(0) // blk, max=nb - 1), x // blk - 1)


@dataclasses.dataclass
class BlockRows(_Space):
    """Row-major twin-block rows of one (S, H, W) volume.

    ``rows`` is (S * H * nb, 2 * blk): row ``(s * H + y) * nb + b`` holds
    columns [b * blk, (b + 2) * blk) of image row (s, y), zero past W.  One
    volume: ``img`` and ``oct_id`` of ``index`` are not read.
    """

    rows: torch.Tensor
    shape: tuple
    blk: int
    nb: int

    @property
    def shapes(self) -> tuple:
        return (self.shape,)

    @property
    def flat(self) -> torch.Tensor:
        return self.rows.reshape(-1)

    def index(self, img, oct_id, s, y, x, x0):
        b = _twin_block(x0, x, self.blk, self.nb)
        row = (s * self.shape[1] + y) * self.nb + b
        return row * (2 * self.blk) + x - b * self.blk


def build_block_rows(vol: torch.Tensor, blk: int = 128) -> BlockRows:
    """(S, H, W) volume -> its ``BlockRows``.  A float32 volume goes through
    kernel H's wrapper (ops/twin_rows.twin_rows_2d: the kernel on the card,
    its plain version on the CPU); the kernels take float32 only, so any
    other type takes the plain pad / reshape / concatenation.  The same
    rows either way."""
    from sift_tpu_torch.ops.twin_rows import twin_rows_2d, twin_rows_2d_plain

    s, h, w = vol.shape
    fn = twin_rows_2d if vol.dtype == torch.float32 else twin_rows_2d_plain
    rows = fn(vol.reshape(s * h, w).contiguous(), blk)
    return BlockRows(rows=rows, shape=(s, h, w), blk=blk, nb=-(-w // blk))


@dataclasses.dataclass
class MultiRows(_Space):
    """Twin-block rows of several (S, H_o, W_o) volumes in one buffer.

    ``rows`` is ([B,] RT, 2 * blk); image ``i``'s rows start at ``i * RT``.
    Block b of image row (s, y) of volume ``o`` holds columns [b * blk,
    (b + 2) * blk) of that row (zero past W_o), so any window of up to
    blk + 1 columns from x0 lies in block x0 // blk.  With nb = nbs[o] and
    H = shapes[o][1], its row from ``bases[o]`` is, by row order:

    * row-major (``shp`` None; ``build_multi_rows``): (s * H + y) * nb + b;
    * strip-interleaved (``shp`` set; kernel E): with r = s * H + y, ls =
      shp[o], st = 1 << ls: (((r >> ls) * nb + b) << ls) + (r & (st - 1));
    * strip-major / layer-minor (``nls`` set with ``shp``; kernel F):
      ((((y >> ls) * nls[o] + s) * nb + b) << ls) + (y & (st - 1)).  Only
      layers [l0, l0 + nls[o]) are stored, and ``bases`` carry a shift of
      -l0 * nb * st so that the formula takes the stack's own layer index.
      A layer outside the stored range is clamped into it for the read
      (only lanes whose values are never used can hold one).

    ``unit``: with the third order, ``unit`` consecutive twin rows (a power
    of two dividing every strip) are one contiguous run; ``rows_u`` is that
    view of the same bytes, ([B,] RT / unit, unit * 2 * blk).
    """

    rows: torch.Tensor
    shapes: tuple
    blk: int
    nbs: tuple
    bases: tuple
    shp: tuple | None = None
    nls: tuple | None = None
    l0: int = 0
    unit: int = 1

    @property
    def flat(self) -> torch.Tensor:
        return self.rows.reshape(-1)

    @property
    def rows_u(self) -> torch.Tensor:
        lead = self.rows.shape[:-2]
        return self.rows.view(*lead, self.rows.shape[-2] // self.unit, self.unit * 2 * self.blk)

    def index(self, img, oct_id, s, y, x, x0):
        nb = lut(self.nbs, oct_id, torch.int64)
        b = _twin_block(x0, x, self.blk, nb)
        if self.shp is None:
            local = (s * self.table(1, oct_id) + y) * nb + b
        else:
            ls = lut(self.shp, oct_id, torch.int64)
            if self.nls is None:
                r = s * self.table(1, oct_id) + y
                group = (r >> ls) * nb
            else:
                nl = lut(self.nls, oct_id, torch.int64)
                r = y
                group = ((y >> ls) * nl + torch.minimum(s.clamp_min(self.l0), self.l0 + nl - 1)) * nb
            local = ((group + b) << ls) + (r & ((1 << ls) - 1))
        row = img.long() * self.rows.shape[-2] + lut(self.bases, oct_id, torch.int64) + local
        return row * (2 * self.blk) + x - b * self.blk


def build_multi_rows(vols: list[torch.Tensor], blk: int = 128) -> MultiRows:
    """(S, H_o, W_o) volumes -> their row-major ``MultiRows``: each
    volume's ``build_block_rows`` rows, one after another.  Float32
    volumes go through kernel H's wrapper (ops/twin_rows.twin_rows_2d_multi:
    one launch for all volumes on the card, its plain version on the CPU);
    any other type takes the plain version."""
    from sift_tpu_torch.ops.twin_rows import twin_rows_2d_multi, twin_rows_2d_multi_plain

    f32 = all(v.dtype == torch.float32 for v in vols)
    fn = twin_rows_2d_multi if f32 else twin_rows_2d_multi_plain
    rows, bases = fn([v.contiguous() for v in vols], blk)
    shapes = tuple(v.shape for v in vols)
    return MultiRows(rows=rows, shapes=shapes, blk=blk,
                     nbs=tuple(-(-s[-1] // blk) for s in shapes), bases=bases)


def twin_strided(vol_b: torch.Tensor, blk: int, st: int, l0: int = 0,
                 nl: int | None = None) -> torch.Tensor:
    """(B, S, H, W) -> (B, nstrips * nl * nb * st, 2 * blk): layers
    [l0, l0 + nl) as twin rows in the strip-major / layer-minor order (the
    JAX package's ``twin_strided_xla``), zero past W and on rows past H."""
    b, s, h, w = vol_b.shape
    nl = s - l0 if nl is None else nl
    nb = -(-w // blk)
    nstrips = -(-h // st)
    v = torch.zeros((b, nl, nstrips * st, (nb + 1) * blk), dtype=vol_b.dtype, device=vol_b.device)
    v[:, :, :h, :w] = vol_b[:, l0:l0 + nl]
    a = v.reshape(b, nl, nstrips, st, nb + 1, blk)
    twin = torch.cat([a[..., :-1, :], a[..., 1:, :]], dim=-1)
    return twin.permute(0, 2, 1, 4, 3, 5).reshape(b, nstrips * nl * nb * st, 2 * blk)


def cube_rows_params(n_layers: int, w: int) -> tuple[int, int, int]:
    """(stride, sw, nbp) of the packed layout of an n_layers-deep octave
    of width w: ``sw`` stored columns per block, ``stride`` of them its
    own, ``nbp`` blocks."""
    sw = 128 // n_layers
    stride = sw - 3
    # ceil((w - 2) / stride), not ceil((w - 3) / stride): interior x goes up
    # to w - 2, which lies in block (w - 3) // stride; when (w - 3) % stride
    # == 0 that is one past ceil((w - 3) / stride) - 1, and clamping the
    # block would read the dx = +1 lane from the next DoG layer's lanes
    # (w = 69 at stride 22).
    nbp = max(1, -(-max(w - 2, 1) // stride))
    return stride, sw, nbp


def cube_rows_plain(d: torch.Tensor, strip: int = 1) -> torch.Tensor:
    """(B, S, H, W) DoG stack -> (B, ceil(H / strip) * strip * nbp, 128)
    cube-packed rows in the strip-block-major order of ``CubeRows`` (the JAX
    package's ``cube_rows_xla``; ``strip`` a power of two, 1 = y-major).
    Lanes >= S * sw, columns outside the image and rows past H are zero."""
    if strip & (strip - 1):
        raise ValueError("cube_rows_plain: strip must be a power of two")
    b, s, h, w = d.shape
    stride, sw, nbp = cube_rows_params(s, w)
    nstr = -(-h // strip)
    # Column c of dp is image column c - 1; block cb's window starts at
    # dp column cb * stride.
    dp = torch.zeros((b, s, nstr * strip, (nbp - 1) * stride + sw), dtype=d.dtype, device=d.device)
    dp[:, :, :h, 1:1 + w] = d  # nbp * stride >= w - 2: the image fits
    win = dp.unfold(-1, sw, stride)  # (b, s, hp, nbp, sw)
    lanes = torch.zeros((b, nstr * strip, nbp, 128), dtype=d.dtype, device=d.device)
    lanes[..., : s * sw] = win.permute(0, 2, 3, 1, 4).reshape(b, nstr * strip, nbp, s * sw)
    lanes = lanes.reshape(b, nstr, strip, nbp, 128).transpose(2, 3)
    return lanes.reshape(b, nstr * nbp * strip, 128)


@dataclasses.dataclass
class CubeRows(_Space):
    """Cube-packed DoG rows: all layers of a column window in one row.

    ``rows`` is ([B,] P, 128).  Row (y, cb) of octave ``o`` holds, at lane
    z * sw + (col - (cb * stride - 1)), layer z of columns [cb * stride - 1,
    cb * stride - 1 + sw); windows overlap by sw - stride = 3 columns, so
    the +-1 neighbourhood of any interior x lies in block (x - 1) // stride.
    Octave ``o`` is tiled into strips of 1 << lss[o] image rows, and row
    (y, cb) is ``bases[o] + (((y >> ls) * nbps[o] + cb) << ls) + (y & (st -
    1))``; ls = 0 is the y-major order.  Unused lanes, columns outside the
    image and rows past H are zero.
    """

    rows: torch.Tensor
    shapes: tuple
    nbps: tuple
    bases: tuple
    stride: int
    sw: int
    lss: tuple

    @property
    def flat(self) -> torch.Tensor:
        return self.rows.reshape(-1)

    def index(self, img, oct_id, s, y, x, x0):
        nbp = lut(self.nbps, oct_id, torch.int64)
        ls = lut(self.lss, oct_id, torch.int64)
        cb = torch.minimum(x0.long().clamp_min(0) // self.stride, nbp - 1)
        row = (
            img.long() * self.rows.shape[-2] + lut(self.bases, oct_id, torch.int64)
            + (((y >> ls) * nbp + cb) << ls) + (y & ((1 << ls) - 1))
        )
        return row * self.rows.shape[-1] + s * self.sw + x - (cb * self.stride - 1)


def from_reference_space(space, batch: int | None = None, l0: int = 0):
    """A gather space of the JAX package (its ``BlockRows``, ``MultiRows``
    or ``CubeRows``: arrays and static fields) as the port's, over the very
    same buffer, so that both packages' gathers can be held to each other.

    ``batch``: the images in a buffer whose leading axes the JAX space has
    flattened (a ``MultiRows`` that carries only ``rows_u``).  ``l0``: the
    first stored layer of a layer-minor ``MultiRows`` (its bases carry the
    shift, its fields do not name it).
    """
    def rows_of(a, width):
        t = torch.from_numpy(np.array(a))
        return t.reshape(batch, -1, width) if batch is not None else t.reshape(
            *t.shape[:-2], -1, width)

    kind = type(space).__name__
    if kind == "BlockRows":
        return BlockRows(rows=rows_of(space.rows, 2 * space.blk), shape=tuple(space.shape),
                         blk=space.blk, nb=space.nb)
    if kind == "MultiRows":
        src = space.rows if space.rows is not None else space.rows_u
        return MultiRows(
            rows=rows_of(src, 2 * space.blk), shapes=tuple(map(tuple, space.shapes)),
            blk=space.blk, nbs=tuple(space.nbs), bases=tuple(space.bases),
            shp=None if space.shp is None else tuple(space.shp),
            nls=None if space.nls is None else tuple(space.nls),
            l0=l0, unit=space.unit,
        )
    if kind == "CubeRows":
        return CubeRows(
            rows=rows_of(space.rows, 128), shapes=tuple(map(tuple, space.shapes)),
            nbps=tuple(space.nbps), bases=tuple(space.bases), stride=space.stride,
            sw=space.sw, lss=tuple(space.lss) or (0,) * len(space.shapes),
        )
    raise TypeError(f"from_reference_space: not a gather space: {kind}")


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
