"""Cylindrical panoramas for wide-FOV sweeps (the JAX package's
``models/cylindrical.py``).

Planar (homography) mosaics blow up as the total field of view approaches
180 degrees.  The classic fix (Brown & Lowe's AutoStitch recipe): estimate
the focal length from the pairwise homographies, prewarp every image into
cylindrical coordinates (where a rotation about the vertical axis becomes a
pure horizontal translation), estimate per-edge rigid motions robustly,
solve them globally, and blend on a flat canvas.

The warps run on the device (inverse-map bilinear gathers); the per-edge
solves are small host-side numpy, with the JAX package's random streams.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sift_tpu_torch.utils.numerics import resolve_device, to_i32, xdiv


def focal_from_homography(h: np.ndarray) -> list[float]:
    """Focal-length candidates from one inter-image homography
    (Brown & Lowe 2003; same estimator OpenCV uses)."""
    h = np.asarray(h, np.float64).reshape(-1)
    out = []
    # f1 (target image)
    d1 = h[6] * h[7]
    d2 = (h[7] - h[6]) * (h[7] + h[6])
    v1 = -(h[0] * h[1] + h[3] * h[4]) / d1 if abs(d1) > 1e-12 else -1
    v2 = (h[0] ** 2 + h[3] ** 2 - h[1] ** 2 - h[4] ** 2) / d2 if abs(d2) > 1e-12 else -1
    if v1 > 0 and v2 > 0:
        out.append(math.sqrt(max(v1, v2) if abs(d1) > abs(d2) else min(v1, v2)))
    elif v1 > 0:
        out.append(math.sqrt(v1))
    elif v2 > 0:
        out.append(math.sqrt(v2))
    # f0 (source image)
    d1 = h[0] * h[3] + h[1] * h[4]
    d2 = h[0] ** 2 + h[1] ** 2 - h[3] ** 2 - h[4] ** 2
    v1 = -h[2] * h[5] / d1 if abs(d1) > 1e-12 else -1
    v2 = (h[5] ** 2 - h[2] ** 2) / d2 if abs(d2) > 1e-12 else -1
    if v1 > 0 and v2 > 0:
        out.append(math.sqrt(max(v1, v2) if abs(d1) > abs(d2) else min(v1, v2)))
    elif v1 > 0:
        out.append(math.sqrt(v1))
    elif v2 > 0:
        out.append(math.sqrt(v2))
    return out


def estimate_focal(
    homographies: list[np.ndarray], width: int, height: int | None = None
) -> float:
    """Median focal over all edges; fallback 0.85 * width.

    The Brown & Lowe estimator assumes the principal point at the origin, so
    pixel-space homographies are conjugated by the image-center translation
    first (same convention as OpenCV's stitching matcher).
    """
    height = height if height is not None else int(width * 3 / 4)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    c_fwd = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]])
    c_inv = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    cands: list[float] = []
    for h in homographies:
        hn = c_inv @ np.asarray(h, np.float64) @ c_fwd
        if abs(hn[2, 2]) < 1e-12:
            continue
        hn = hn / hn[2, 2]
        cands.extend(focal_from_homography(hn))
    good = [f for f in cands if 0.2 * width < f < 10 * width]
    if good:
        return float(np.median(good))
    return 0.85 * width


def cylindrical_warp(img: torch.Tensor, f: float, border: int = 0,
                     supersample: int = 2):
    """Project an (H, W, C) float32 image onto a cylinder of focal f, on the
    image's device.

    Output pixel (xc, yc): theta = (xc - cx) / f, hgt = (yc - cy) / f;
    source x = cx + f * tan(theta), y = cy + f * hgt / cos(theta).
    Returns (warped (H, W + 2*border, C), mask (H, W + 2*border)).

    ``supersample``: subpixel grid averaged per output pixel.  The cylinder
    map minifies vertically by cos(theta), and plain bilinear minification
    aliases fine structure into moire; an n x n subsample average is an
    area prefilter at the output rate (where the local scale is ~1 it is a
    half-pixel box blur, visually neutral).
    """
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    out_w = w + 2 * border
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(out_w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    flat = img.reshape(h * w, img.shape[2])

    def gather(yi, xi):
        return flat[yi.long() * w + xi.long()]

    def tap(dx, dy):
        theta = xdiv(xs + dx - border - cx, f)
        hgt = xdiv(ys + dy - cy, f)
        sx = cx + f * torch.tan(theta)
        sy = cy + f * hgt / torch.cos(theta)
        inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1) & (
            theta.abs() < 1.2
        )
        x0 = to_i32(torch.clamp(torch.floor(sx), 0, w - 1))
        y0 = to_i32(torch.clamp(torch.floor(sy), 0, h - 1))
        x1 = torch.clamp(x0 + 1, max=w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        fx = (sx - x0)[..., None]
        fy = (sy - y0)[..., None]
        v = (
            gather(y0, x0) * (1 - fx) * (1 - fy)
            + gather(y0, x1) * fx * (1 - fy)
            + gather(y1, x0) * (1 - fx) * fy
            + gather(y1, x1) * fx * fy
        )
        return v, inside.to(torch.float32)

    n = max(1, supersample)
    offs = [(i + 0.5) / n - 0.5 for i in range(n)]
    acc_v = 0.0
    acc_m = 0.0
    for dy in offs:
        for dx in offs:
            v, m = tap(dx, dy)
            acc_v = acc_v + v * m[..., None]
            acc_m = acc_m + m
    mask = (acc_m >= (n * n) * 0.5).to(torch.float32)
    v = acc_v / torch.clamp(acc_m, min=1.0)[..., None]
    return v * mask[..., None], mask


def robust_translation(p1: np.ndarray, p2: np.ndarray, ok: np.ndarray,
                       tol: float = 3.0) -> tuple[np.ndarray, int]:
    """Translation p1 -> p2 by median + inlier-mean (host-side, tiny)."""
    d = (p2 - p1)[ok]
    if len(d) == 0:
        return np.zeros(2), 0
    med = np.median(d, axis=0)
    inl = np.linalg.norm(d - med, axis=1) < tol
    if inl.sum() == 0:
        return med, 0
    return d[inl].mean(axis=0), int(inl.sum())


def _rot2(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s], [s, c]])


def robust_rigid(p1: np.ndarray, p2: np.ndarray, ok: np.ndarray,
                 tol: float = 3.0, n_hyp: int = 256, seed: int = 0,
                 ) -> tuple[float, np.ndarray, int]:
    """Rigid transform p2 ~ R(alpha) p1 + t by 2-point RANSAC + Procrustes.

    Pure per-edge translations cannot absorb camera roll between frames, so
    hypotheses come from match pairs (two correspondences determine a 2-D
    rigid transform); the best consensus set is refined with one Procrustes
    solve + re-selection.  Alpha is radians about the warped image's origin
    (the convention of the 3x3 [R | t] composite homographies).  The pairs
    are drawn by ``np.random.default_rng(seed)``, the JAX package's stream.
    """
    q1, q2 = p1[ok], p2[ok]
    n = len(q1)
    if n < 2:
        t, cnt = robust_translation(p1, p2, ok, tol)
        return 0.0, t, cnt
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, n, (n_hyp, 2))
    v1 = q1[pick[:, 1]] - q1[pick[:, 0]]
    v2 = q2[pick[:, 1]] - q2[pick[:, 0]]
    ang = np.arctan2(v2[:, 1], v2[:, 0]) - np.arctan2(v1[:, 1], v1[:, 0])
    c, s = np.cos(ang), np.sin(ang)
    rot1 = np.stack(
        [c[:, None] * q1[None, :, 0] - s[:, None] * q1[None, :, 1],
         s[:, None] * q1[None, :, 0] + c[:, None] * q1[None, :, 1]], axis=-1
    )  # (H, N, 2)
    t_h = q2[pick[:, 0]] - rot1[np.arange(n_hyp), pick[:, 0]]
    res = q2[None, :, :] - (rot1 + t_h[:, None, :])
    inl_h = (res ** 2).sum(-1) < tol * tol
    best = int(inl_h.sum(1).argmax())
    sel = inl_h[best]
    if sel.sum() < 2:
        t, cnt = robust_translation(p1, p2, ok, tol)
        return 0.0, t, cnt

    def procrustes(sel):
        c1, c2 = q1[sel].mean(0), q2[sel].mean(0)
        a1, a2 = q1[sel] - c1, q2[sel] - c2
        sxx = float((a1 * a2).sum())
        sxy = float((a1[:, 0] * a2[:, 1] - a1[:, 1] * a2[:, 0]).sum())
        alpha = float(np.arctan2(sxy, sxx))
        t = c2 - _rot2(alpha) @ c1
        return alpha, t

    alpha, t = procrustes(sel)
    res = q2 - (q1 @ _rot2(alpha).T + t)
    sel2 = np.linalg.norm(res, axis=1) < tol
    if sel2.sum() >= sel.sum():
        alpha, t = procrustes(sel2)
        sel = sel2
    return alpha, t, int(sel.sum())


def solve_global_rigid(
    n_images: int,
    center: int,
    edges: list[tuple[int, int]],
    alphas: list[float],
    translations: list[np.ndarray],
    weights: list[float] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Global least-squares (angle, offset) per image from per-edge rigids.

    Edge k maps image ``edges[k][0]`` coords into ``edges[k][1]`` coords:
    p_j = R(alpha_k) p_i + t_k.  With per-image canvas warps
    W_i(p) = R(phi_i) p + o_i, consistency W_i(p_i) = W_j(p_j) gives the two
    linear systems

        phi_i - phi_j = alpha_k          (angles; gauge phi_center = 0)
        o_i - o_j = R(phi_j) t_k         (offsets, after solving angles)

    Returns (phis (N,), offsets (N, 2)).
    """
    from sift_tpu_torch.models.blend import solve_global_offsets

    if not edges:
        return np.zeros(n_images), np.zeros((n_images, 2))
    w = np.sqrt(np.asarray(
        weights if weights is not None else [1.0] * len(edges), np.float64
    ).clip(min=1e-3))
    a = np.zeros((len(edges) + 1, n_images))
    b = np.zeros(len(edges) + 1)
    for k, ((i, j), al) in enumerate(zip(edges, alphas)):
        a[k, i] = w[k]
        a[k, j] = -w[k]
        b[k] = w[k] * al
    a[len(edges), center] = max(10.0 * w.max(), 1.0)
    phis, *_ = np.linalg.lstsq(a, b, rcond=None)
    phis = phis - phis[center]
    t_rot = [
        _rot2(phis[j]) @ np.asarray(t, np.float64)
        for (i, j), t in zip(edges, translations)
    ]
    offsets = solve_global_offsets(n_images, center, edges, t_rot, weights)
    return phis, offsets


def stitch_scene_cylindrical(
    images: list[np.ndarray],
    graph,
    cfg=None,
    focal: float | None = None,
    seam_aware: bool = True,
    diagnostics: dict | None = None,
    device="cuda",
) -> np.ndarray:
    """Wide-FOV panorama: cylindrical prewarp + globally-adjusted rigids.

    Focal comes from the pairwise planar homographies unless given.  After
    prewarping, every STITCH-GRAPH edge contributes a robust rigid motion
    (inlier-weighted); per-image angles and offsets come from one global
    least-squares solve over the whole edge set, refined by two reweighted
    re-solves, and the warped images composite with gain compensation +
    seam-aware multiband blending.
    """
    from sift_tpu_torch import SiftConfig, detect_and_describe
    from sift_tpu_torch.models.stitch import composite, match_points, ransac_homography

    cfg = cfg or SiftConfig()
    dev = resolve_device(device)
    parents = graph.bfs_parents()
    tree_edges = [
        (i, p) for i, p in parents.items() if i != graph.center_index
    ]

    # Pass 1: planar pipeline for focal estimation (tree edges suffice).
    kps = [detect_and_describe(img, cfg, device=dev) for img in images]
    hs = []
    for i, parent in tree_edges:
        p1, p2, ok = match_points(kps[i], kps[parent], cfg.ratio_threshold)
        h, _, _ = ransac_homography(p1, p2, ok, 1024)
        hs.append(h)
    hs_host = (torch.stack(hs).cpu().numpy().astype(np.float64) if hs
               else np.zeros((0, 3, 3)))
    f = focal if focal is not None else estimate_focal(
        list(hs_host), images[0].shape[1], images[0].shape[0]
    )

    # Pass 2: cylindrical prewarp + per-edge rigids on the warped images,
    # over the full match graph (connected via bfs_parents' component).
    warped = [
        cylindrical_warp(torch.from_numpy(np.asarray(img, np.float32)).to(dev), float(f))[0]
        for img in images
    ]
    kps_w = [detect_and_describe(w, cfg, device=dev) for w in warped]

    all_edges = [
        (a, b) for a, b in graph.edges
        if a in parents and b in parents and a < len(images) and b < len(images)
    ]
    bufs = []
    for a, b in all_edges:
        p1, p2, ok = match_points(kps_w[a], kps_w[b], cfg.ratio_threshold)
        bufs.append(torch.cat([p1, p2, ok[:, None].to(p1.dtype)], dim=1))
    # One host read for all match buffers: (edges, N, 5) = p1, p2, ok.
    host = torch.stack(bufs).cpu().numpy() if bufs else np.zeros((0, 0, 5))
    results = [(a, b, buf[:, 0:2], buf[:, 2:4], buf[:, 4] > 0)
               for (a, b), buf in zip(all_edges, host)]
    edges, alphas, translations, weights = [], [], [], []
    for a, b, p1, p2, ok in results:
        al, t, n_inl = robust_rigid(p1, p2, ok)
        if n_inl >= 4:
            edges.append((a, b))
            alphas.append(al)
            translations.append(t)
            weights.append(float(n_inl))
    phis, offsets = solve_global_rigid(
        len(images), graph.center_index, edges, alphas, translations, weights
    )

    # IRLS refinement: two reweighted re-solves, down-weighting edges whose
    # matched features disagree with the solved global poses (median canvas
    # residual, Cauchy weight at sigma = 4 px): parallax and scene motion
    # make a few edges fight the global solution.
    pts_by_edge = {(a, b): (p1, p2, ok) for a, b, p1, p2, ok in results}
    sigma = 4.0
    for _ in range(2):
        new_w = []
        for (a, b), w0 in zip(edges, weights):
            p1, p2, ok = pts_by_edge[(a, b)]
            if ok.sum() == 0:
                new_w.append(w0)
                continue
            ca = p1[ok] @ _rot2(phis[a]).T + offsets[a]
            cb = p2[ok] @ _rot2(phis[b]).T + offsets[b]
            r = float(np.median(np.linalg.norm(ca - cb, axis=1)))
            new_w.append(w0 / (1.0 + (r / sigma) ** 2))
        phis, offsets = solve_global_rigid(
            len(images), graph.center_index, edges, alphas, translations,
            new_w,
        )

    # Drop images not reachable from the center through surviving edges:
    # their offsets are unconstrained (lstsq minimum-norm ~ 0) and would
    # paste them straight onto the panorama center.
    reach = {graph.center_index}
    frontier = [graph.center_index]
    adj: dict[int, list[int]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    while frontier:
        u = frontier.pop()
        for v in adj.get(u, ()):
            if v not in reach:
                reach.add(v)
                frontier.append(v)
    dropped = sorted(set(parents) - reach)
    if dropped:
        print(f"warning: dropping images with no surviving translation "
              f"edges to the center: {dropped}")

    order = sorted(set(parents) & reach)
    homs = []
    for i in order:
        t = np.eye(3)
        t[:2, :2] = _rot2(phis[i])
        t[0, 2], t[1, 2] = offsets[i]
        homs.append(t)
    warped_np = [warped[i].cpu().numpy() for i in order]
    if diagnostics is not None:
        # Geometric registration quality: median per-edge canvas residual of
        # the matched features under the solved global warps (immune to
        # scene motion, unlike the photometric overlap_consistency).
        def canvas(i, p):
            return p @ _rot2(phis[i]).T + offsets[i]

        surviving = set(edges)
        edge_res = []
        for a, b, p1, p2, ok in results:
            if (a, b) not in surviving or ok.sum() == 0:
                continue
            r = np.linalg.norm(canvas(a, p1[ok]) - canvas(b, p2[ok]), axis=1)
            edge_res.append(float(np.median(r)))
        diagnostics.update(
            focal=float(f), offsets=offsets, phis=phis, edges=edges,
            warped=warped_np, homographies=homs,
            edge_residual_px=(float(np.median(edge_res)) if edge_res
                              else float("nan")),
            edge_residuals=edge_res,
        )
    return composite(warped_np, homs, seam_aware=seam_aware, device=dev)
