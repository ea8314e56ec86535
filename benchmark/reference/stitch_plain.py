"""A plain panorama: the yardstick that decides ``correct`` for the
stitching cells.

Plain PyTorch in float32 (TF32 off), a frame and an edge at a time, frozen
here so that a change to the program cannot move it.  It computes the
reference's stitching workflow (github.com/ahmedhassayoune/sift-project,
README: ratio matching, a RANSAC homography per edge, chaining toward a
centre image, warp and blend) with the semantics that ``sift_tpu_torch``'s
``stitch`` command gives it, in the same float32 expression order, so on
the same matches the program's homographies and canvas are these:

1. The graph: consecutive frames (i, i + 1), centred on frame n // 2; each
   frame's parent is its neighbour toward the centre.
2. Matching, per edge (frame, parent): the frame's keypoints fill a buffer
   of ``lanes`` lanes (the configuration's ``ori_cap``) in their order, the
   rest empty (position (0, 0), zero descriptor); every lane is matched
   against the parent's keypoints (``match_plain``); a lane's match counts
   where it is accepted and the lane holds a keypoint.
3. RANSAC: K hypotheses of four lanes.  A CPU ``torch.Generator`` seeded
   with ``seed`` draws (K, 4) float64 uniforms u; each picks the
   floor(u * n)-th of the n counted lanes (none counted: the last lane).
   Both point sets are Hartley-normalised over the counted lanes; each
   hypothesis is the exact homography through its four normalised pairs,
   in pixels T2^-1 H T1; a counted lane is an inlier when its squared
   reprojection error is below the threshold's square, and the first
   hypothesis with most inliers wins.  Its inliers are refit by the
   least-squares DLT (the normal equations' eigenvector of the smallest
   eigenvalue); the refit is kept if it has at least as many inliers, else
   the winning hypothesis; the result is scaled to h33 = 1.
4. Chaining to the centre in float64 (H_i = H_parent H_(i->parent)), the
   centre rotation (0 for the chain), the canvas from the warped corners
   clamped to ``max_canvas`` a side (and its origin to -max_canvas / 2).
5. Gains (Brown & Lowe) from a quarter-size warp of every image, then the
   composite: a 5-band Laplacian blend over feather-argmax seams where the
   canvas holds at most ``max_multiband_pixels``, else the feather average
   over strips of ``strip_rows`` rows (gains applied first); without
   ``seam_aware`` the feather average without gains.

Warping inverse-maps every canvas pixel through the image's homography,
samples bilinearly and weighs by the feather (the product of the clamped
normalised distances to the image's borders, plus 1e-6, inside the image).

Departures from an ideal statement of the workflow, each kept because the
program has it (ROADMAP.md, queue 3, keeps both for parity with the JAX
package):

* the refit's weights repeat each lane's twice over rows ordered [the u
  rows of every lane, the v rows of every lane], so row k takes lane
  k // 2's weight (``jnp.repeat``): the lane buffer's size and its empty
  lanes enter the refit, which is why step 2 models the buffer.  While at
  most half the lanes hold keypoints only u rows carry weight, the second
  row of H is left free, the refit's inliers are few and the winning
  hypothesis stands (every edge of CAVE-01 at 3072 lanes);
* the feather average is not clipped to [0, 255].

The four-point hypothesis is the 8 x 8 linear solve with h33 = 1 (a 1e-12
ridge on its diagonal), the program's, not the null vector of its normal
equations: the two differ in rounding, and RANSAC's choice among
near-tied hypotheses follows rounding, so only the same solve keeps a
sound program's homographies within rounding of these.

``variant`` computes it otherwise, in the program's place when the limits
are set (``benchmark/clients/panorama.py``'s control):

* ``"reordered"``: a sound float32 program: each projective row sums
  h_i0 x + (h_i1 y + h_i2), the bilinear sum runs from the last corner to
  the first and the DLT's normal matrix sums its rows in reverse;
* ``"tf32"``: the nearest precision below float32: warp coordinates,
  bilinear weights and the DLT's products' operands rounded to TF32 (a
  10-bit mantissa), the sums in float32.

It imports neither JAX nor the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import match_plain
from benchmark.reference.sift_plain import tf32, to_i32

VARIANTS = ("frozen", "reordered", "tf32")
# The program's constants (models/blend.py's defaults).
GAIN_SCALE = 0.25
GAIN_SIGMA_N = 10.0
GAIN_SIGMA_G = 0.1
GAIN_MIN_OVERLAP = 64
BANDS = 5
BINOMIAL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _check(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: {VARIANTS}")


def chain(n: int) -> tuple[dict, int]:
    """({frame: parent}, centre) of the chain graph over ``n`` frames."""
    c = n // 2
    return {i: i + 1 if i < c else i - 1 for i in range(n) if i != c}, c


# --- step 3: RANSAC ---------------------------------------------------------

def matmul3(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def project(h, pts, eps: float = 1e-12, variant: str = "frozen"):
    """(..., 3, 3) x (..., N, 2): each row (h_i0 x + h_i1 y) + h_i2 (as
    ``reordered``: h_i0 x + (h_i1 y + h_i2)), over the third (|w| below
    ``eps`` taken as ``eps``)."""
    x, y = pts[..., 0], pts[..., 1]

    def row(i):
        if variant == "reordered":
            return h[..., i, 0, None] * x + (h[..., i, 1, None] * y + h[..., i, 2, None])
        return h[..., i, 0, None] * x + h[..., i, 1, None] * y + h[..., i, 2, None]

    w = row(2)
    w = torch.where(w.abs() < eps, torch.full_like(w, eps), w)
    return torch.stack([row(0) / w, row(1) / w], dim=-1)


def draw(counted: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """(k, 4) lanes: the floor(u * n)-th counted lane of each uniform."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    u = torch.rand((k, 4), generator=gen, dtype=torch.float64)
    lanes = torch.nonzero(counted.cpu())[:, 0]
    if not len(lanes):
        return torch.full((k, 4), len(counted) - 1, dtype=torch.int64, device=counted.device)
    return lanes[torch.floor(u * len(lanes)).to(torch.int64)].to(counted.device)


def normalise(p, vf, n):
    """Hartley normalisation over the counted lanes: (p', T), p' = T p."""
    mean = (p * vf).sum(0) / n
    d = torch.sqrt(((p - mean) ** 2).sum(1))
    spread = torch.clamp((d * vf[:, 0]).sum() / n, min=1e-8)
    s = torch.full_like(spread, math.sqrt(2.0)) / spread
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    t = torch.stack([torch.stack([s, zero, -s * mean[0]]), torch.stack([zero, s, -s * mean[1]]),
                     torch.stack([zero, zero, one])])
    return (p - mean) * s, t


def four_point(p1, p2, variant: str):
    """(K, 4, 2) pairs -> (K, 3, 3): the 8 x 8 system with h33 = 1."""
    if variant == "tf32":
        p1, p2 = tf32(p1), tf32(p2)
    x, y, u, v = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    a = torch.cat([torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1),
                   torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)], -2)
    b = torch.cat([u, v], -1)[..., None]
    ridge = torch.eye(8, dtype=a.dtype, device=a.device) * 1e-12
    h8 = torch.linalg.solve_ex(a + ridge, b)[0][..., 0]
    return torch.cat([h8, torch.ones_like(h8[..., :1])], -1).reshape(-1, 3, 3)


def dlt_refit(p1, p2, w, variant: str):
    """The least-squares homography of the weighted DLT rows (the rows of
    every lane's u equation, then of its v equation; row k weighed by lane
    k // 2's weight)."""
    if variant == "tf32":
        p1, p2 = tf32(p1), tf32(p2)
    x, y, u, v = p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    a = torch.cat([torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1),
                   torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)], -2)
    a = a * w.repeat_interleave(2)[:, None]
    if variant == "tf32":
        a = tf32(a)
    if variant == "reordered":
        a = a.flip(0)
    ata = (a[:, :, None] * a[:, None, :]).sum(-3)
    return torch.linalg.eigh(ata)[1][:, 0].reshape(3, 3)


def ransac(p1, p2, counted, num_hypotheses: int, threshold: float, seed: int,
           variant: str = "frozen") -> torch.Tensor:
    """The homography (3, 3) float32 mapping ``p1`` -> ``p2`` ((N, 2) lanes,
    ``counted`` (N,) bool)."""
    f32 = p1.dtype
    n = torch.clamp(counted.sum(), min=1).to(f32)
    vf = counted.to(f32)[:, None]
    p1n, t1 = normalise(p1, vf, n)
    p2n, t2 = normalise(p2, vf, n)
    idx = draw(counted, num_hypotheses, seed)
    t2inv = torch.linalg.inv_ex(t2)[0]
    h_px = matmul3(matmul3(t2inv, four_point(p1n[idx], p2n[idx], variant)), t1)
    thr2 = threshold * threshold
    err2 = ((project(h_px, p1[None], variant=variant) - p2[None]) ** 2).sum(-1)
    inl = (err2 < thr2) & counted[None, :]
    votes = inl.sum(1)
    best = int(torch.argmax(votes))
    h_ref = matmul3(matmul3(t2inv, dlt_refit(p1n, p2n, inl[best].to(f32), variant)), t1)
    err2_r = ((project(h_ref[None], p1[None], variant=variant)[0] - p2) ** 2).sum(-1)
    h = h_ref if int(((err2_r < thr2) & counted).sum()) >= int(votes[best]) else h_px[best]
    h33 = h[2, 2]
    return h / torch.where(h33.abs() < 1e-12, torch.ones_like(h33), h33)


def edge_matches(kps: list, lanes: int, ratio: float, dev) -> dict:
    """{(frame, parent): (p1, p2, counted)} over the chain (step 2): the
    frame's lane buffer of ``lanes`` positions (lanes, 2), each lane's
    matched position in the parent (lanes, 2) and the lanes whose match
    counts (lanes,) bool.  ``kps[i]``: frame i's keypoints, a dict with
    ``x``, ``y`` and ``desc`` ((n, 128) uint8), arrays or tensors."""
    parents, _ = chain(len(kps))
    out = {}
    for i, p in parents.items():
        q, t = kps[i], kps[p]
        n = len(q["x"])
        xy = torch.zeros((lanes, 2), dtype=torch.float32, device=dev)
        xy[:n, 0] = torch.as_tensor(q["x"], device=dev)
        xy[:n, 1] = torch.as_tensor(q["y"], device=dev)
        desc = torch.zeros((lanes, 128), dtype=torch.uint8, device=dev)
        desc[:n] = torch.as_tensor(q["desc"], device=dev)
        t_xy = torch.stack([torch.as_tensor(t["x"], device=dev),
                            torch.as_tensor(t["y"], device=dev)], -1).to(torch.float32)
        idx, acc, _ = match_plain.ratio_matches(desc, torch.as_tensor(t["desc"], device=dev),
                                                ratio)
        counted = acc & (torch.arange(lanes, device=dev) < n)
        out[(i, p)] = (xy, t_xy[idx] if len(t_xy) else torch.zeros_like(xy), counted)
    return out


def edge_homographies(kps: list, params: dict, lanes: int, ratio: float, dev,
                      variant: str = "frozen", matches: dict | None = None) -> dict:
    """{(frame, parent): H frame -> parent, (3, 3) float64} over the chain,
    by RANSAC on ``edge_matches`` (given as ``matches``, or computed)."""
    _check(variant)
    matches = matches if matches is not None else edge_matches(kps, lanes, ratio, dev)
    return {e: ransac(p1, p2, counted, params["num_hypotheses"], params["inlier_threshold"],
                      params["seed"], variant).cpu().numpy().astype(np.float64)
            for e, (p1, p2, counted) in matches.items()}


# --- step 4: chaining and the canvas ---------------------------------------

def centred(images, h_edge: dict, rotation: float = 0.0) -> list[np.ndarray]:
    """Per frame, in order, its homography into the centre frame rotated by
    ``rotation`` about the centre image's middle (float64)."""
    parents, c = chain(len(images))
    hc = {c: np.eye(3)}

    def walk(i):
        if i not in hc:
            hc[i] = walk(parents[i]) @ h_edge[(i, parents[i])]
        return hc[i]

    for i in parents:
        walk(i)
    hh, ww = images[c].shape[:2]
    cx, cy = (ww - 1) / 2.0, (hh - 1) / 2.0
    cs, sn = math.cos(rotation), math.sin(rotation)
    rot = (np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]])
           @ np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]])
           @ np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]]))
    return [rot @ hc[i] for i in sorted(hc)]


def corners(images, hs, max_canvas: int) -> np.ndarray:
    """(N, 4, 2) warped corner pixels, capped to +-2 max_canvas."""
    out = []
    for img, h in zip(images, hs):
        hh, ww = img.shape[:2]
        c = np.array([[0, 0], [ww - 1, 0], [0, hh - 1], [ww - 1, hh - 1]], np.float64)
        ch = np.concatenate([c, np.ones((4, 1))], axis=1) @ np.asarray(h).T
        wz = ch[:, 2:3]
        out.append(ch[:, :2] / np.where(np.abs(wz) < 1e-9, 1e-9, wz))
    return np.clip(np.nan_to_num(np.stack(out), nan=0.0, posinf=max_canvas, neginf=-max_canvas),
                   -2.0 * max_canvas, 2.0 * max_canvas)


def canvas(images, hs, max_canvas: int):
    """(out_h, out_w, T): T shifts the centre frame into the canvas."""
    c = corners(images, hs, max_canvas).reshape(-1, 2)
    x_min, y_min = np.floor(c.min(axis=0))
    x_max, y_max = np.ceil(c.max(axis=0))
    x_min = max(x_min, -float(max_canvas) / 2)
    y_min = max(y_min, -float(max_canvas) / 2)
    out_w = min(int(x_max - x_min + 1), max_canvas)
    out_h = min(int(y_max - y_min + 1), max_canvas)
    return out_h, out_w, np.array([[1, 0, -x_min], [0, 1, -y_min], [0, 0, 1]], np.float64)


# --- step 5: warping, gains, blending ---------------------------------------

def warp(image, h_inv, out_h: int, out_w: int, variant: str = "frozen"):
    """(weighted rgb (out_h, out_w, C), feather weight (out_h, out_w)) of
    one (H, W, C) float32 image inverse-mapped through ``h_inv``."""
    h, w, c = image.shape
    f32, dev = image.dtype, image.device
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=f32, device=dev),
                            torch.arange(out_w, dtype=f32, device=dev), indexing="ij")
    src = project(h_inv.to(f32)[None], torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)[None],
                  variant=variant)[0]
    sx, sy = src[:, 0], src[:, 1]
    if variant == "tf32":
        sx, sy = tf32(sx), tf32(sy)
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    x0 = to_i32(torch.clamp(torch.floor(sx), 0, w - 1))
    y0 = to_i32(torch.clamp(torch.floor(sy), 0, h - 1))
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (sx - x0.to(f32))[:, None]
    fy = (sy - y0.to(f32))[:, None]
    gx, gy = 1 - fx, 1 - fy
    if variant == "tf32":
        fx, fy, gx, gy = tf32(fx), tf32(fy), tf32(gx), tf32(gy)
    flat = image.reshape(h * w, c)

    def at(yi, xi):
        return flat[yi.long() * w + xi.long()]

    terms = [at(y0, x0) * gx * gy, at(y0, x1) * fx * gy, at(y1, x0) * gx * fy,
             at(y1, x1) * fx * fy]
    if variant == "reordered":
        terms = terms[::-1]
    val = terms[0] + terms[1] + terms[2] + terms[3]
    half_w = torch.tensor((w - 1) * 0.5, dtype=f32, device=dev)
    half_h = torch.tensor((h - 1) * 0.5, dtype=f32, device=dev)
    dx = torch.minimum(sx, (w - 1) - sx) / half_w
    dy = torch.minimum(sy, (h - 1) - sy) / half_h
    weight = torch.clamp(dx, 0, 1) * torch.clamp(dy, 0, 1) + 1e-6
    weight = torch.where(inside, weight, torch.zeros_like(weight))
    return (val * weight[:, None]).reshape(out_h, out_w, c), weight.reshape(out_h, out_w)


def gains(images, hs_canvas, out_h: int, out_w: int, dev, variant: str) -> np.ndarray:
    """Brown & Lowe gains from the overlaps of a ``GAIN_SCALE`` canvas."""
    n = len(images)
    lh = max(int(round(out_h * GAIN_SCALE)), 8)
    lw = max(int(round(out_w * GAIN_SCALE)), 8)
    s = np.diag([lw / out_w, lh / out_h, 1.0])
    accs, wgts = [], []
    for img, h in zip(images, hs_canvas):
        h_inv = np.linalg.inv(s @ np.asarray(h, np.float64)).astype(np.float32)
        acc, wgt = warp(torch.from_numpy(np.asarray(img, np.float32)).to(dev),
                        torch.from_numpy(h_inv).to(dev), lh, lw, variant)
        accs.append(acc)
        wgts.append(wgt)
    wgts = torch.stack(wgts)
    lum = torch.stack(accs).mean(-1) / torch.clamp(wgts, min=1e-8)
    m = (wgts > 0).reshape(n, -1).to(torch.float64)
    lm = lum.reshape(n, -1).to(torch.float64) * m
    overlap, sums = torch.stack([m @ m.T, lm @ m.T]).cpu().numpy()
    a, b = np.zeros((n, n)), np.zeros(n)
    seen = False
    for i in range(n):
        for j in range(n):
            n_ij = int(overlap[i, j])
            if i == j or n_ij < GAIN_MIN_OVERLAP:
                continue
            seen = True
            mi, mj = sums[i, j] / n_ij, sums[j, i] / n_ij
            a[i, i] += n_ij * (mi * mi / GAIN_SIGMA_N**2 + 1.0 / GAIN_SIGMA_G**2)
            a[i, j] -= n_ij * mi * mj / GAIN_SIGMA_N**2
            b[i] += n_ij / GAIN_SIGMA_G**2
    if not seen:
        return np.ones(n)
    return np.clip(np.linalg.solve(a + 1e-9 * np.eye(n), b), 0.5, 2.0)


def feather(images, hs, max_canvas: int, strip_rows: int, g, dev, variant: str) -> np.ndarray:
    """The feather average over row strips (``g``: gains or None)."""
    out_h, out_w, t = canvas(images, hs, max_canvas)
    h_invs = np.stack([np.linalg.inv(t @ np.asarray(h)) for h in hs]).astype(np.float32)
    if g is not None:
        images = [np.asarray(im, np.float32) * np.float32(gi) for im, gi in zip(images, g)]
    strip_h = min(strip_rows, out_h)
    out = np.zeros((out_h, out_w, images[0].shape[2]), np.float32)
    imgs = [torch.from_numpy(np.asarray(im, np.float32)).to(dev) for im in images]
    for s in range(-(-out_h // strip_h)):
        shift = np.array([[1, 0, 0], [0, 1, float(s * strip_h)], [0, 0, 1]], np.float64)
        h_s = torch.from_numpy((h_invs.astype(np.float64) @ shift).astype(np.float32)).to(dev)
        acc = torch.zeros((strip_h, out_w, out.shape[2]), dtype=torch.float32, device=dev)
        wacc = torch.zeros((strip_h, out_w), dtype=torch.float32, device=dev)
        for img, h_inv in zip(imgs, h_s):
            a, wgt = warp(img, h_inv, strip_h, out_w, variant)
            acc = acc + a
            wacc = wacc + wgt
        rows = slice(s * strip_h, min((s + 1) * strip_h, out_h))
        strip = acc / torch.clamp(wacc, min=1e-8)[:, :, None]
        out[rows] = strip.cpu().numpy()[: rows.stop - rows.start]
    return out


def blur5(x):
    """5-tap binomial blur of (H, W, C), zero padding, renormalised by the
    blurred ones."""
    def conv(v, axis):
        pad = [0, 0, 0, 0, 0, 0]
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 2
        vp = F.pad(v, pad)
        out = 0.0
        for t, k in enumerate(BINOMIAL):
            out = out + k * vp.narrow(axis, t, v.shape[axis])
        return out
    return conv(conv(x, 0), 1) / conv(conv(torch.ones_like(x[:, :, :1]), 0), 1)


def down(x):
    return blur5(x)[::2, ::2]


def up(x, th: int, tw: int):
    """Bilinear resize of (H, W, C), half-pixel centres."""
    return F.interpolate(x.permute(2, 0, 1)[None], size=(th, tw), mode="bilinear",
                         align_corners=False, antialias=False)[0].permute(1, 2, 0)


def multiband(images, hs, max_canvas: int, g, dev, variant: str) -> np.ndarray:
    """Laplacian-pyramid blend of ``BANDS`` levels over feather-argmax seams,
    each level a normalised convolution over the image's coverage."""
    out_h, out_w, t = canvas(images, hs, max_canvas)
    mult = 1 << (BANDS - 1)
    ph, pw = -(-out_h // mult) * mult, -(-out_w // mult) * mult
    h_invs = [torch.from_numpy(np.linalg.inv(t @ np.asarray(h)).astype(np.float32)).to(dev)
              for h in hs]
    g = torch.from_numpy(np.asarray(np.ones(len(images)) if g is None else g, np.float32)).to(dev)
    imgs = [torch.from_numpy(np.asarray(im, np.float32)).to(dev) for im in images]
    best_w = torch.zeros((ph, pw), dtype=torch.float32, device=dev)
    best_i = torch.full((ph, pw), -1, dtype=torch.int32, device=dev)
    for i, (img, h_inv) in enumerate(zip(imgs, h_invs)):
        wgt = warp(img, h_inv, ph, pw, variant)[1]
        better = wgt > best_w
        best_w = torch.where(better, wgt, best_w)
        best_i = torch.where(better, torch.full_like(best_i, i), best_i)
    shapes = [(ph, pw)]
    for _ in range(BANDS - 1):
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    c = imgs[0].shape[2]
    nums = [torch.zeros((*s, c), dtype=torch.float32, device=dev) for s in shapes]
    dens = [torch.zeros((*s, 1), dtype=torch.float32, device=dev) for s in shapes]
    for i, (img, h_inv) in enumerate(zip(imgs, h_invs)):
        acc, wgt = warp(img, h_inv, ph, pw, variant)
        gv = [g[i] * acc / torch.clamp(wgt, min=1e-8)[:, :, None]]
        gc = [(wgt > 0).to(torch.float32)[:, :, None]]
        gm = [((best_i == i) & (wgt > 0)).to(torch.float32)[:, :, None]]
        for _ in range(BANDS - 1):
            cn = down(gc[-1])
            gv.append(down(gv[-1] * gc[-1]) / torch.clamp(cn, min=1e-6))
            gc.append(cn)
            gm.append(down(gm[-1]))
        for lvl in range(BANDS):
            lap = gv[lvl] - up(gv[lvl + 1], *shapes[lvl]) if lvl < BANDS - 1 else gv[lvl]
            nums[lvl] = nums[lvl] + gm[lvl] * lap
            dens[lvl] = dens[lvl] + gm[lvl]
    out = nums[-1] / torch.clamp(dens[-1], min=1e-8)
    for lvl in range(BANDS - 2, -1, -1):
        out = up(out, *shapes[lvl]) + nums[lvl] / torch.clamp(dens[lvl], min=1e-8)
    out = torch.where((best_w > 0)[:, :, None], out, torch.zeros_like(out))
    return np.clip(out.cpu().numpy()[:out_h, :out_w], 0.0, 255.0)


def panorama(images: list, h_edge: dict, params: dict, dev, variant: str = "frozen") -> np.ndarray:
    """The (out_h, out_w, C) float32 canvas of ``images`` ((H, W, C) arrays
    in frame order) through the chain's edge homographies."""
    _check(variant)
    hs = centred(images, h_edge)
    images = [np.asarray(im, np.float32) for im in images]
    mc = params["max_canvas"]
    if not params["seam_aware"]:
        return feather(images, hs, mc, params["strip_rows"], None, dev, variant)
    out_h, out_w, t = canvas(images, hs, mc)
    g = gains(images, [t @ np.asarray(h) for h in hs], out_h, out_w, dev, variant)
    if out_h * out_w > params["max_multiband_pixels"] or len({im.shape for im in images}) > 1:
        return feather(images, hs, mc, params["strip_rows"], g, dev, variant)
    return multiband(images, hs, mc, g, dev, variant)


def stitch(images: list, kps: list, params: dict, lanes: int, ratio: float, dev,
           variant: str = "frozen") -> tuple[dict, np.ndarray]:
    """(edge homographies, canvas) of one scene: steps 1-5."""
    h_edge = edge_homographies(kps, params, lanes, ratio, dev, variant)
    return h_edge, panorama(images, h_edge, params, dev, variant)
