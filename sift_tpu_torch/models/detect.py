"""DoG extrema compaction and sub-pixel Newton refinement.

Port of ``sift_tpu/models/detect.py``.  On the front route extrema are
located from the octave front's per-128-lane popcounts
(``extrema_from_counts``); on the non-front route from the DoG stacks
(``detect_extrema_all``), in the same (octave, z, y, x) order.  Both are
refined by the reference's <= 5-step Newton loop (src/sift.cpp:330-436) as
masked batched steps over lane buffers, with the cascade that compacts the
still-moving minority before later steps; the staged path refines one
octave at a time without the cascade (``refine_octave_keypoints``).  Lanes
carry a leading batch dimension (B, n); cubes come from a gather space of
the DoGs (ops/gather.py): cube-packed rows, twin rows or the plain stacks.
All arithmetic keeps the reference's expression order, so the float64
profile is bit-faithful; cube values are /255 like get_pixel_cube
(src/sift.cpp:39).
"""

from __future__ import annotations

import math

import torch

from sift_tpu_torch.config import MAX_CONVERGENCE_STEPS, SiftConfig
from sift_tpu_torch.ops.gather import build_block_rows, compact_mask, gather_cubes, lut
from sift_tpu_torch.ops.octave_front import extremum_mask
from sift_tpu_torch.utils.keypoints import Keypoints
from sift_tpu_torch.utils.numerics import round_half_away, to_i32, xdiv


def extrema_from_counts(masks, counts, cap: int):
    """Global extrema compaction over all octaves of each image.

    ``masks[o]``: (B, n_int, H_o, nbm_o*128) 0/1; ``counts[o]``: (B, n_int,
    H_o, nbm_o) int32 popcounts of each 128-lane mask block.  Returns
    (oct_id (B, cap) int32, zyx (B, cap, 3) int32, valid (B, cap), total
    (B,) int32) in (octave, z, y, x) order; ``total`` > cap means the
    capacity clipped real extrema.
    """
    bsz, n_int = counts[0].shape[:2]
    hs = [c.shape[2] for c in counts]
    nbms = [c.shape[3] for c in counts]
    rbases = [0]
    for h, nbm in zip(hs, nbms):
        rbases.append(rbases[-1] + n_int * h * nbm)
    dev = counts[0].device

    flat = torch.cat([c.reshape(bsz, -1) for c in counts], dim=1).long()
    csum = torch.cumsum(flat, dim=1)  # inclusive, (B, R)
    total = csum[:, -1]
    k = torch.arange(cap, device=dev).expand(bsz, cap).contiguous()
    row = torch.searchsorted(csum, k, right=True)  # row holding bit k
    rowc = row.clamp_max(rbases[-1] - 1)
    before = torch.gather(csum, 1, (row - 1).clamp(0, rbases[-1] - 1))
    rank = k - torch.where(row > 0, before, torch.zeros_like(before))

    mrows = torch.cat([m.reshape(bsz, -1, 128) for m in masks], dim=1)
    g = torch.gather(mrows, 1, rowc[..., None].expand(bsz, cap, 128)) > 0
    pref = torch.cumsum(g.to(torch.int32), dim=-1)
    hit = g & (pref == (rank[..., None] + 1))
    lane = torch.argmax(hit.to(torch.int32), dim=-1)

    oct_id = torch.zeros_like(rowc)
    for o in range(1, len(counts)):
        oct_id += (rowc >= rbases[o]).long()
    local = rowc - lut(rbases[:-1], oct_id, torch.int64)
    nbm_l = lut(nbms, oct_id, torch.int64)
    h_l = lut(hs, oct_id, torch.int64)
    y = (local // nbm_l) % h_l
    z = local // (nbm_l * h_l) + 1  # interior layers start at z = 1
    x = (local % nbm_l) * 128 + lane
    zyx = torch.stack([z, y, x], dim=-1).to(torch.int32)
    valid = k < total[:, None]
    return oct_id.to(torch.int32), zyx, valid, total.to(torch.int32)


def detect_octave_extrema(dog, threshold: float, cap: int, window_size: int = 3):
    """Extrema of one (D, H, W) DoG stack: (zyx (cap, 3) int32, valid (cap,),
    total) in ascending (z, y, x) order; ``total`` > cap means the capacity
    clipped real extrema."""
    b = window_size // 2
    is_ext = extremum_mask(dog, threshold, window_size)
    flat = is_ext.reshape(-1)
    idx, valid = compact_mask(flat, cap)
    _, h2, w2 = is_ext.shape
    zyx = torch.stack([idx // (h2 * w2) + b, (idx // w2) % h2 + b, idx % w2 + b], dim=-1)
    return zyx.to(torch.int32), valid, flat.sum(dtype=torch.int32)


def detect_extrema_all(dogs, threshold: float, cap: int, window_size: int = 3):
    """Extrema of all octaves of each image in one global buffer.

    ``dogs[o]``: (B, D, H_o, W_o).  Returns (oct_id (B, cap) int32, zyx
    (B, cap, 3) int32, valid (B, cap), total (B,) int32) in (octave, z, y,
    x) order, lane for lane what ``extrema_from_counts`` gives from the
    front's masks.
    """
    b = window_size // 2
    masks = [extremum_mask(d, threshold, window_size) for d in dogs]
    bsz = masks[0].shape[0]
    offs = [0]
    for m in masks:
        offs.append(offs[-1] + m[0].numel())
    flat = torch.cat([m.reshape(bsz, -1) for m in masks], dim=1)
    idx, valid = compact_mask(flat, cap)
    oct_id = torch.zeros_like(idx)
    for o in range(1, len(masks)):
        oct_id += (idx >= offs[o]).long()
    local = idx - lut(offs[:-1], oct_id, torch.int64)
    h2 = lut([m.shape[2] for m in masks], oct_id, torch.int64)
    w2 = lut([m.shape[3] for m in masks], oct_id, torch.int64)
    zyx = torch.stack(
        [local // (h2 * w2) + b, (local // w2) % h2 + b, local % w2 + b], dim=-1
    ).to(torch.int32)
    return oct_id.to(torch.int32), zyx, valid, flat.sum(-1, dtype=torch.int32)


def refine_cascade_caps(cfg: SiftConfig, n: int):
    """The Newton phase schedule ((cap, steps), ...) after the full step 1:
    steps {2} on n//4 lanes and {3,4,5} on n//8 (the still-moving share
    shrinks fast on real images); ``cfg.refine_active_cap`` pins the older
    single phase of 4 steps."""
    if cfg.refine_active_cap:
        return ((cfg.refine_active_cap, 4),)
    return ((max(128, n // 4), 1), (max(128, n // 8), 3))


def _gradient(c):
    """(dz, dx, dy) central differences (src/sift.cpp:49-55)."""
    g0 = 0.5 * (c[..., 2, 1, 1] - c[..., 0, 1, 1])
    g1 = 0.5 * (c[..., 1, 1, 2] - c[..., 1, 1, 0])
    g2 = 0.5 * (c[..., 1, 2, 1] - c[..., 1, 0, 1])
    return g0, g1, g2


def _hessian(c):
    """Symmetric 3x3 Hessian entries (src/sift.cpp:60-80); axes (z, x, y)."""
    ctr = c[..., 1, 1, 1]
    h00 = c[..., 0, 1, 1] - 2 * ctr + c[..., 2, 1, 1]
    h11 = c[..., 1, 1, 0] - 2 * ctr + c[..., 1, 1, 2]
    h22 = c[..., 1, 0, 1] - 2 * ctr + c[..., 1, 2, 1]
    h01 = 0.25 * (c[..., 2, 1, 2] - c[..., 2, 1, 0] - c[..., 0, 1, 2] + c[..., 0, 1, 0])
    h02 = 0.25 * (c[..., 2, 2, 1] - c[..., 2, 0, 1] - c[..., 0, 2, 1] + c[..., 0, 0, 1])
    h12 = 0.25 * (c[..., 1, 0, 0] - c[..., 1, 0, 2] - c[..., 1, 2, 0] + c[..., 1, 2, 2])
    return h00, h11, h22, h01, h02, h12


def _fit_quadratic(g, h):
    """offset = -H^{-1} g via the adjugate, in the order of
    src/sift.cpp:86-106 (no singularity guard, like the reference)."""
    g0, g1, g2 = g
    h00, h11, h22, h01, h02, h12 = h
    det = (
        h00 * h11 * h22
        + 2 * (h01 * h12 * h02)
        - h02 * h11 * h02
        - h00 * h12 * h12
        - h01 * h01 * h22
    )
    i00 = (h11 * h22 - h12 * h12) / det
    i01 = (h02 * h12 - h01 * h22) / det
    i02 = (h01 * h12 - h02 * h11) / det
    i11 = (h00 * h22 - h02 * h02) / det
    i12 = (h02 * h01 - h00 * h12) / det
    i22 = (h00 * h11 - h01 * h01) / det
    o0 = -i00 * g0 - i01 * g1 - i02 * g2
    o1 = -i01 * g0 - i11 * g1 - i12 * g2
    o2 = -i02 * g0 - i12 * g1 - i22 * g2
    return o0, o1, o2


_STATE_FIELDS = ("g", "h", "off")


def _newton_init(zyx, valid, dtype):
    zero = torch.zeros(valid.shape, dtype=dtype, device=valid.device)
    return dict(
        pos=zyx, active=valid, converged=torch.zeros_like(valid),
        g=(zero,) * 3, h=(zero,) * 6, off=(zero,) * 3, center=zero,
    )


def _newton_refine(cube_fn, state, dims, border: int, steps: int):
    """Masked Newton steps; a step is a per-lane no-op once the lane has
    converged or left the volume.  ``dims`` = (depth, h_lane, w_lane)."""
    depth, h_lane, w_lane = dims
    hi = torch.stack(
        [torch.full_like(h_lane, depth - 1 - border), h_lane - 1 - border,
         w_lane - 1 - border], dim=-1,
    ).to(torch.int32)
    for _ in range(steps):
        st = state
        cubes = cube_fn(st["pos"])
        g = _gradient(cubes)
        h = _hessian(cubes)
        off = _fit_quadratic(g, h)
        max_off = torch.maximum(
            off[0].abs(), torch.maximum(off[1].abs(), off[2].abs())
        )
        conv_now = st["active"] & (max_off < 0.5)  # CONVERGENCE_THR

        def sel(new, old):
            return tuple(torch.where(conv_now, a, b) for a, b in zip(new, old))

        moving = st["active"] & ~conv_now
        step = torch.stack(
            [to_i32(round_half_away(off[0])), to_i32(round_half_away(off[2])),
             to_i32(round_half_away(off[1]))], dim=-1,
        )  # (dz, dy, dx)
        newpos = st["pos"] + step
        z, y, x = newpos[..., 0], newpos[..., 1], newpos[..., 2]
        in_bounds = (
            (x >= border) & (x < w_lane - border)
            & (y >= border) & (y < h_lane - border)
            & (z >= border) & (z < depth - border)
        )
        pos = torch.where(moving[..., None], newpos, st["pos"])
        # Lanes that left the volume are rejected (src/sift.cpp:405-410);
        # clamp them so later gathers stay in range.
        pos = torch.minimum(pos.clamp_min(border), hi)
        state = dict(
            pos=pos,
            active=moving & in_bounds,
            converged=st["converged"] | conv_now,
            g=sel(g, st["g"]), h=sel(h, st["h"]), off=sel(off, st["off"]),
            center=torch.where(conv_now, cubes[..., 1, 1, 1], st["center"]),
        )
    return state


def _accept_and_emit(state, octave_scale, oct_id, cfg: SiftConfig, dtype):
    """Contrast + edge tests and keypoint emission (src/sift.cpp:365-429)."""
    g0, g1, g2 = state["g"]
    o0, o1, o2 = state["off"]
    h00, h11, h22, h01, h02, h12 = state["h"]

    dot_go = g0 * o0 + g1 * o1 + g2 * o2
    interp = state["center"] + 0.5 * dot_go
    valid_contrast = (interp.abs() * cfg.intervals) >= cfg.contrast_threshold

    # Spatial 2x2 Hessian: [1][1] = dxx, [2][2] = dyy, [1][2] = dxy.
    tr = h11 + h22
    det2 = h11 * h22 - h12 * h12
    not_edge = (tr > 0) & ((tr * tr * cfg.eigen_ratio) < (
        (cfg.eigen_ratio + 1) * (cfg.eigen_ratio + 1) * det2
    ))
    accept = state["converged"] & valid_contrast & not_edge

    pos = state["pos"]
    z, y, x = pos[..., 0], pos[..., 1], pos[..., 2]
    fx = octave_scale * (x.to(dtype) + o1)
    fy = octave_scale * (y.to(dtype) + o2)
    # init_sigma * 2^octave * pow(2, (layer + offset_z) / intervals)
    # (src/sift.cpp:427-429); float64 runs replace it with the host's
    # glibc pow (models/sift.py).
    size = (cfg.init_sigma * octave_scale) * torch.exp2(
        xdiv(z.to(dtype) + o0, float(cfg.intervals))
    )
    zero = torch.zeros_like(fx)
    kp = Keypoints(
        x=fx, y=fy, octave=oct_id, layer=z.to(torch.int32), size=size,
        pori=zero,
        desc=torch.zeros(fx.shape + (128,), dtype=torch.uint8, device=fx.device),
        valid=accept,
    )
    return kp, o0


def _take(a, idx):
    if a.dim() == idx.dim() + 1:
        return torch.gather(a, 1, idx[..., None].expand(*idx.shape, a.shape[-1]))
    return torch.gather(a, 1, idx)


def _scatter(parent, widx, child):
    """parent[b, widx[b, k]] = child[b, k]; index n (one past the end) is
    a discard slot."""
    pad = torch.cat([parent, parent[:, :1]], dim=1)
    idx = widx if child.dim() == widx.dim() else widx[..., None].expand_as(child)
    return pad.scatter(1, idx, child)[:, : parent.shape[1]]


def refine_keypoints_all(space, oct_id, zyx, valid, cfg: SiftConfig):
    """Newton refinement of mixed-octave extrema lanes (B, n).

    ``space``: a gather space (ops/gather.py) of the DoG stacks of all
    octaves.  Step 1 runs on every lane; before each later phase the
    still-moving lanes are compacted into a smaller buffer
    (refine_cascade_caps) and scattered back afterwards -- exact, because
    a lane entering a phase carries only (pos, active).
    Returns (keypoints (B, n), layer offset off0 (B, n), n_active (B, P)):
    n_active counts the lanes still moving entering each phase, for the
    overflow check against the phase caps.
    """
    border = cfg.window_size // 2
    bsz, n = valid.shape
    dtype = space.flat.dtype
    depth = space.shapes[0][0]
    img = torch.arange(bsz, device=valid.device)[:, None].expand(bsz, n)

    def cube(im, oc):
        return lambda pos: xdiv(gather_cubes(space, im, oc, pos), 255.0)

    def dims(oc):
        return depth, space.table(1, oc), space.table(2, oc)

    state = _newton_refine(
        cube(img, oct_id), _newton_init(zyx, valid, dtype), dims(oct_id),
        border, steps=1,
    )
    cur, cur_oct, cur_img = state, oct_id, img
    n_active, levels = [], []
    for cap_i, nsteps in refine_cascade_caps(cfg, n):
        n_active.append(cur["active"].sum(-1, dtype=torch.int32))
        cur_n = cur["active"].shape[1]
        if cap_i >= cur_n:
            cur = _newton_refine(cube(cur_img, cur_oct), cur, dims(cur_oct),
                                 border, nsteps)
            continue
        idx, sel = compact_mask(cur["active"], cap_i)
        levels.append((idx, sel, cur, cur_n))
        cur_oct, cur_img = _take(cur_oct, idx), _take(cur_img, idx)
        cur = _newton_refine(
            cube(cur_img, cur_oct),
            _newton_init(_take(cur["pos"], idx), sel, dtype),
            dims(cur_oct), border, nsteps,
        )

    # Unwind: scatter each phase's lanes back into its parent buffer.
    for idx, sel, parent, parent_n in reversed(levels):
        widx = torch.where(sel, idx, torch.full_like(idx, parent_n))
        merged = dict(
            pos=_scatter(parent["pos"], widx, cur["pos"]),
            active=parent["active"],
            converged=_scatter(parent["converged"], widx, cur["converged"]),
            center=_scatter(parent["center"], widx, cur["center"]),
        )
        for f in _STATE_FIELDS:
            merged[f] = tuple(
                _scatter(p, widx, c) for p, c in zip(parent[f], cur[f])
            )
        cur = merged

    octave_scale = lut(
        [float(math.pow(2, o)) for o in range(len(space.shapes))], oct_id, dtype
    )
    kp, off0 = _accept_and_emit(cur, octave_scale, oct_id, cfg, dtype)
    return kp, off0, torch.stack(n_active, dim=-1)


def refine_octave_keypoints(dog, zyx, valid, octave: int, cfg: SiftConfig):
    """Newton refinement of one octave's extrema lanes (the staged path):
    all MAX_CONVERGENCE_STEPS steps on every lane, no cascade.  ``dog``:
    (D, H, W); ``zyx`` (n, 3), ``valid`` (n,).  Returns (keypoints (n,),
    layer offset off0 (n,)), lane for lane what ``refine_keypoints_all``
    gives for the same lanes.  Cubes come from the octave's row-major twin
    rows, as in the JAX package (kernel H in float32 on the card)."""
    space = build_block_rows(dog)
    n = valid.shape[0]
    zero = torch.zeros(n, dtype=torch.int64, device=valid.device)
    state = _newton_refine(
        lambda pos: xdiv(gather_cubes(space, zero, zero, pos), 255.0),
        _newton_init(zyx, valid, dog.dtype),
        (dog.shape[0], space.table(1, zero), space.table(2, zero)),
        cfg.window_size // 2, MAX_CONVERGENCE_STEPS,
    )
    octave_scale = torch.full((n,), math.pow(2, octave), dtype=dog.dtype, device=dog.device)
    oct_id = torch.full((n,), octave, dtype=torch.int32, device=dog.device)
    return _accept_and_emit(state, octave_scale, oct_id, cfg, dog.dtype)
