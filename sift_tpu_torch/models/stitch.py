"""Homography estimation and panorama stitching (the JAX package's
``models/stitch.py``).

Ratio-test matching along the edges of a STITCH-GRAPH, RANSAC homography
per edge, chaining toward the center image (with its rotation angle), then
warp and blend onto a common canvas (src: the reference's stitching
notebook, rebuilt by the JAX package).

- RANSAC is a fixed batch of K hypotheses solved at once: K x 4 samples,
  an 8x8 solve each, inlier counts for all of them, argmax.  The samples
  are drawn by ``sample_hypotheses`` from a CPU generator seeded with
  ``seed``, so the CPU and the card take the same hypotheses; the rest
  (``ransac_with_samples``) runs on the points' device without a host read.
- Warping inverse-maps every canvas pixel through the image's homography
  and samples it bilinearly with a feather weight.

No stage here has a TPU kernel in the JAX package (they are XLA), so all
of it is plain PyTorch.  Every product runs in full float32 (TF32 is off,
see the package docstring): the projective maps are written out as
elementwise products and sums, which round alike on the CPU and the card.

Under a torch profiler (``utils/profiling``) the slice marks its stages,
``stitch.scene`` > ``stitch.edges`` > ``stitch.ransac``, ``stitch.layout``,
``stitch.gains`` (``models/blend``) and ``stitch.blend``, and its host
waits, ``stitch.sync.{homographies,strip,upload,gains}`` (and, inside
``stitch.ransac``, ``geometry.min_eigvec``'s ``geometry.sync.eigh``); it counts
``stitch.edges``, ``stitch.hypothesis_lanes`` (K x N a RANSAC),
``blend.px_warped`` (canvas pixels a blend samples, per image) and
``blend.px_footprint`` (of those, the pixels inside the bounding box of
the image's warped corners).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sift_tpu_torch.models import geometry
from sift_tpu_torch.models.geometry import first_max, matmul3, min_eigvec, pick, take_lanes
from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.numerics import resolve_device, to_i32, xdiv

# --------------------------------------------------------------------------
# Homography estimation
# --------------------------------------------------------------------------


def _dlt_matrix(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """DLT rows for correspondences p1 -> p2: (..., N, 2) -> (..., 2N, 9)."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=-1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def _solve_h(a: torch.Tensor) -> torch.Tensor:
    """Least-squares null vector of (..., M, 9) -> (..., 3, 3) homography."""
    h = min_eigvec(a)
    return h.reshape(*h.shape[:-1], 3, 3)


def _solve_h_4pt(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Exact 4-point homography via an 8x8 linear solve (h33 = 1 gauge).

    (..., 4, 2) -> (..., 3, 3).  A degenerate sample (a repeated point, h33
    ~ 0) gives a singular system: ``solve_ex`` returns non-finite values or
    garbage for it without raising (``torch.linalg.solve`` would raise); a
    non-finite hypothesis scores zero inliers (``nan < thr`` is false) and
    garbage few, as in the JAX package (whose 1e-12 ridge, kept here,
    vanishes against entries of about 1 in float32).
    """
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    a = torch.cat([r1, r2], dim=-2)  # (..., 8, 8)
    b = torch.cat([u, v], dim=-1)[..., None]  # (..., 8, 1)
    eye = torch.eye(8, dtype=a.dtype, device=a.device) * 1e-12
    h8 = torch.linalg.solve_ex(a + eye, b)[0][..., 0]
    ones = torch.ones_like(h8[..., :1])
    return torch.cat([h8, ones], dim=-1).reshape(*h8.shape[:-1], 3, 3)


def _apply_h(h: torch.Tensor, pts: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(..., 3, 3) x (..., N, 2) -> (..., N, 2) projective transform.

    Each row is ``(h_i0 * x + h_i1 * y) + h_i2``, every product and sum
    rounded on its own in full precision (the JAX package's einsum at
    HIGHEST: at bf16, canvas coordinates >= 1024 snap to 8-16 px steps).
    """
    x, y = pts[..., 0], pts[..., 1]

    def row(i):
        return h[..., i, 0, None] * x + h[..., i, 1, None] * y + h[..., i, 2, None]

    w = row(2)
    w = torch.where(w.abs() < eps, torch.full_like(w, eps), w)
    return torch.stack([row(0) / w, row(1) / w], dim=-1)


def sample_hypotheses(valid: torch.Tensor, num_hypotheses: int, seed: int = 0) -> torch.Tensor:
    """(K, 4) int64 indices of valid lanes, drawn with replacement, on
    ``valid``'s device: ``geometry.sample_choice`` with 4 lanes a sample."""
    return geometry.sample_choice(valid, num_hypotheses, 4, seed)


def _normalize(p: torch.Tensor, vf: torch.Tensor, nvalid: torch.Tensor):
    """Hartley normalization over the valid lanes: (p', T) with p' = T p;
    p (..., N, 2), vf (..., N, 1), nvalid (...)."""
    mean = (p * vf).sum(-2) / nvalid[..., None]
    d = torch.sqrt(((p - mean[..., None, :]) ** 2).sum(-1))
    spread = torch.clamp((d * vf[..., 0]).sum(-1) / nvalid, min=1e-8)
    scale = torch.full_like(spread, math.sqrt(2.0)) / spread
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    t = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], -1),
        torch.stack([zero, scale, -scale * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return (p - mean[..., None, :]) * scale[..., None, None], t


def ransac_homography(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    valid: torch.Tensor,
    num_hypotheses: int = 2048,
    inlier_threshold: float = 3.0,
    seed: int = 0,
):
    """Estimate H mapping pts1 -> pts2 with batched-hypothesis RANSAC.

    Returns (H (3,3), inlier_mask (N,), num_inliers ()), on the points'
    device.  All shapes are static: pts are fixed-capacity buffers with a
    validity mask.
    """
    with profiling.span("stitch.ransac"):
        profiling.count("stitch.hypothesis_lanes", num_hypotheses * pts1.shape[0])
        idx = sample_hypotheses(valid, num_hypotheses, seed)
        return ransac_with_samples(pts1, pts2, valid, idx, inlier_threshold)


def ransac_with_samples(pts1, pts2, valid, idx, inlier_threshold: float = 3.0):
    """``ransac_homography`` on given (K, 4) sample indices.

    With a leading pair axis on every argument (pts (P, N, 2), valid
    (P, N), idx (P, K, 4)) it runs P RANSACs as one launch chain and
    returns (P, 3, 3), (P, N), (P,): each pair's answer is what its own
    call computes (bit for bit on the CPU; the card's batched solvers may
    round a last bit otherwise).
    """
    dtype = pts1.dtype
    nvalid = torch.clamp(valid.sum(-1), min=1).to(dtype)
    vf = valid.to(dtype)[..., None]
    p1n, t1 = _normalize(pts1, vf, nvalid)
    p2n, t2 = _normalize(pts2, vf, nvalid)

    h = _solve_h_4pt(take_lanes(p1n, idx), take_lanes(p2n, idx))  # (..., K, 3, 3), normalized

    # Inlier counting in pixel space: H_px = T2^-1 H T1.
    t2inv = torch.linalg.inv_ex(t2)[0]
    h_px = matmul3(matmul3(t2inv[..., None, :, :], h), t1[..., None, :, :])
    thr2 = inlier_threshold * inlier_threshold
    proj = _apply_h(h_px, pts1[..., None, :, :])  # (..., K, N, 2)
    err2 = ((proj - pts2[..., None, :, :]) ** 2).sum(-1)
    inl = (err2 < thr2) & valid[..., None, :]
    counts = inl.sum(-1)
    best = first_max(counts)  # jnp.argmax's first maximum, kept on the device
    inlier_mask = pick(inl, best)

    # Least-squares refit on the inliers (masked DLT rows).  The weights
    # repeat each lane's twice over rows ordered [r1 of every lane, r2 of
    # every lane], so row k takes lane k // 2's weight: the JAX package's
    # ``jnp.repeat``, kept for parity (ROADMAP.md, queue 3).
    w = inlier_mask.to(dtype)
    a_all = _dlt_matrix(p1n, p2n) * w.repeat_interleave(2, -1)[..., None]
    h_ref_px = matmul3(matmul3(t2inv, _solve_h(a_all)), t1)

    # Fall back to the best sample hypothesis if the refit is worse.
    err2_r = ((_apply_h(h_ref_px, pts1) - pts2) ** 2).sum(-1)
    inl_r = (err2_r < thr2) & valid
    use_refit = inl_r.sum(-1) >= pick(counts, best)
    h_out = torch.where(use_refit[..., None, None], h_ref_px, pick(h_px, best))
    inlier_out = torch.where(use_refit[..., None], inl_r, inlier_mask)
    h33 = h_out[..., 2, 2]
    h_out = h_out / torch.where(h33.abs() < 1e-12, torch.ones_like(h33), h33)[..., None, None]
    return h_out, inlier_out, inlier_out.sum(-1)


# --------------------------------------------------------------------------
# Warping and blending
# --------------------------------------------------------------------------


def warp_accumulate(image: torch.Tensor, h_inv: torch.Tensor, out_h: int, out_w: int):
    """Inverse-warp one (H, W, C) image onto an (out_h, out_w) canvas.

    Returns (weighted_rgb (out_h, out_w, C), weight (out_h, out_w)) with a
    feather weight (normalized distance to the image border) for seamless
    multi-image blending, on the image's device.
    """
    h, w = image.shape[0], image.shape[1]
    dtype, dev = image.dtype, image.device

    ys, xs = torch.meshgrid(
        torch.arange(out_h, dtype=dtype, device=dev),
        torch.arange(out_w, dtype=dtype, device=dev),
        indexing="ij",
    )
    pts = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    src = _apply_h(h_inv.to(dtype)[None], pts[None])[0]
    sx, sy = src[:, 0], src[:, 1]

    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    # XLA's float -> int32 conversion (NaN -> 0, saturating): a degenerate
    # homography must not index outside the image.
    x0 = to_i32(torch.clamp(torch.floor(sx), 0, w - 1))
    y0 = to_i32(torch.clamp(torch.floor(sy), 0, h - 1))
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = sx - x0.to(dtype)
    fy = sy - y0.to(dtype)

    flat = image.reshape(h * w, image.shape[2])

    def sample(yi, xi):
        return flat[yi.long() * w + xi.long()]

    v00 = sample(y0, x0)
    v01 = sample(y0, x1)
    v10 = sample(y1, x0)
    v11 = sample(y1, x1)
    fxc = fx[:, None]
    fyc = fy[:, None]
    val = (
        v00 * (1 - fxc) * (1 - fyc)
        + v01 * fxc * (1 - fyc)
        + v10 * (1 - fxc) * fyc
        + v11 * fxc * fyc
    )

    # Feather: product of normalized distances to the four borders.
    dx = xdiv(torch.minimum(sx, (w - 1) - sx), (w - 1) * 0.5)
    dy = xdiv(torch.minimum(sy, (h - 1) - sy), (h - 1) * 0.5)
    weight = torch.clamp(dx, 0, 1) * torch.clamp(dy, 0, 1) + 1e-6
    weight = torch.where(inside, weight, torch.zeros_like(weight))

    acc = val * weight[:, None]
    return acc.reshape(out_h, out_w, image.shape[2]), weight.reshape(out_h, out_w)


def _blend_strip(images, h_invs: torch.Tensor, strip_h: int, out_w: int) -> torch.Tensor:
    """Feather-average one canvas strip over the images ((H_i, W_i, C)
    tensors), accumulated on the device."""
    c = images[0].shape[-1]
    dev = h_invs.device
    acc = torch.zeros((strip_h, out_w, c), dtype=torch.float32, device=dev)
    wacc = torch.zeros((strip_h, out_w), dtype=torch.float32, device=dev)
    for img, h_inv in zip(images, h_invs):
        a, wgt = warp_accumulate(img, h_inv, strip_h, out_w)
        acc = acc + a
        wacc = wacc + wgt
    return acc / torch.clamp(wacc, min=1e-8)[:, :, None]


def _warped_corners(images, homographies, max_canvas: int = 8192) -> np.ndarray:
    """(N, 4, 2) images of each image's four corner pixels in the common
    frame, capped to +-2 ``max_canvas``.  Host numpy."""
    corners = []
    for img, h in zip(images, homographies):
        hh, ww = img.shape[0], img.shape[1]
        c = np.array(
            [[0, 0], [ww - 1, 0], [0, hh - 1], [ww - 1, hh - 1]], np.float64
        )
        ch = np.concatenate([c, np.ones((4, 1))], axis=1) @ np.asarray(h).T
        wz = ch[:, 2:3]
        wz = np.where(np.abs(wz) < 1e-9, 1e-9, wz)
        corners.append(ch[:, :2] / wz)
    corners = np.stack(corners)
    # Degenerate homographies throw corners to infinity; the canvas clamp
    # bounds them, so cap here to keep the arithmetic finite.
    return np.clip(
        np.nan_to_num(corners, nan=0.0, posinf=max_canvas, neginf=-max_canvas),
        -2.0 * max_canvas, 2.0 * max_canvas,
    )


def _canvas_layout(
    images: list[np.ndarray],
    homographies: list[np.ndarray],
    max_canvas: int = 8192,
) -> tuple[int, int, np.ndarray]:
    """Canvas (out_h, out_w, origin-shift T) from warped image corners.

    ``homographies[i]`` maps image i pixel coords -> common frame; ``T`` is
    the translation that brings the common frame into canvas coords.  Bounds
    are clamped to ``max_canvas`` per side (planar projective chains blow up
    as the panorama field of view approaches 180 degrees).  Host numpy.
    """
    with profiling.span("stitch.layout"):
        corners = _warped_corners(images, homographies, max_canvas).reshape(-1, 2)
        x_min, y_min = np.floor(corners.min(axis=0))
        x_max, y_max = np.ceil(corners.max(axis=0))
        x_min = max(x_min, -float(max_canvas) / 2)
        y_min = max(y_min, -float(max_canvas) / 2)
        out_w = min(int(x_max - x_min + 1), max_canvas)
        out_h = min(int(y_max - y_min + 1), max_canvas)
        t = np.array([[1, 0, -x_min], [0, 1, -y_min], [0, 0, 1]], np.float64)
    return out_h, out_w, t


def count_blend(images, homographies, t: np.ndarray, out_h: int, out_w: int,
                sampled: int, passes: int = 1, max_canvas: int = 8192) -> None:
    """While a profiler records, per image and pass over the images:
    ``blend.px_warped`` += ``sampled`` (the canvas pixels one warp of the
    image samples) and ``blend.px_footprint`` += the pixels of the (out_h,
    out_w) canvas inside the bounding box of the image's warped corners
    (``t`` the canvas shift)."""
    if not profiling.recording():
        return
    c = _warped_corners(images, homographies, max_canvas) + t[:2, 2]
    x0 = np.clip(np.floor(c[..., 0].min(1)), 0, out_w)
    x1 = np.clip(np.floor(c[..., 0].max(1)) + 1, 0, out_w)
    y0 = np.clip(np.floor(c[..., 1].min(1)), 0, out_h)
    y1 = np.clip(np.floor(c[..., 1].max(1)) + 1, 0, out_h)
    profiling.count("blend.px_warped", passes * sampled * len(images))
    profiling.count("blend.px_footprint", passes * int(((x1 - x0) * (y1 - y0)).sum()))


def blend_warped(
    images: list[np.ndarray],
    homographies: list[np.ndarray],
    max_canvas: int = 8192,
    strip_rows: int = 1024,
    gains: np.ndarray | None = None,
    device="cuda",
) -> np.ndarray:
    """Warp every image through its canvas homography and feather-blend.

    The canvas streams in row strips; accumulation over images runs on the
    device and each strip is read to the host once.  For seam-aware
    compositing see ``blend.multiband_blend``, the scene drivers' default;
    this streaming feather average is the arbitrarily-large canvas
    fallback.
    """
    dev = resolve_device(device)
    with profiling.span("stitch.blend"):
        out_h, out_w, t = _canvas_layout(images, homographies, max_canvas)

        h_invs = np.stack(
            [np.linalg.inv(t @ np.asarray(h)) for h in homographies]
        ).astype(np.float32)
        if gains is not None:
            # Photometric gain compensation: a host-side scale of working copies.
            images = [
                np.asarray(im, np.float32) * np.float32(g)
                for im, g in zip(images, gains)
            ]
        strip_h = min(strip_rows, out_h)
        n_strips = -(-out_h // strip_h)
        count_blend(images, homographies, t, out_h, out_w, n_strips * strip_h * out_w,
                    max_canvas=max_canvas)
        out = np.zeros((out_h, out_w, images[0].shape[2]), np.float32)
        with profiling.span("stitch.sync.upload"):
            imgs = [torch.from_numpy(np.asarray(im, np.float32)).to(dev) for im in images]
        for s in range(n_strips):
            t_strip = np.array(
                [[1, 0, 0], [0, 1, float(s * strip_h)], [0, 0, 1]], np.float32
            )
            h_inv_s = (h_invs.astype(np.float64) @ t_strip.astype(np.float64)).astype(
                np.float32
            )
            with profiling.span("stitch.sync.upload"):
                h_inv_s = torch.from_numpy(h_inv_s).to(dev)
            strip = _blend_strip(imgs, h_inv_s, strip_h, out_w)
            rows = slice(s * strip_h, min((s + 1) * strip_h, out_h))
            with profiling.span("stitch.sync.strip"):
                out[rows] = strip.cpu().numpy()[: rows.stop - rows.start]
    return out


# --------------------------------------------------------------------------
# Scene stitching driver
# --------------------------------------------------------------------------


def match_points(kp1, kp2, ratio_threshold: float = 0.75):
    """Matched point buffers for RANSAC: ((N,2), (N,2), valid), on the
    keypoints' device."""
    from sift_tpu_torch.models.match import match_descriptors

    idx, accept, _, _ = match_descriptors(
        kp1.desc, kp1.valid, kp2.desc, kp2.valid, ratio_threshold,
        device=kp1.x.device,
    )
    p1 = torch.stack([kp1.x, kp1.y], dim=-1)
    p2 = torch.stack([kp2.x, kp2.y], dim=-1)[idx.long()]
    return p1, p2, accept


def stitch_pair(img1, img2, cfg=None, num_hypotheses: int = 2048,
                device="cuda") -> np.ndarray:
    """Two-image panorama (the reference's scene_1 workflow)."""
    from sift_tpu_torch import SiftConfig, detect_and_describe

    cfg = cfg or SiftConfig()
    kp1 = detect_and_describe(img1, cfg, device=device)
    kp2 = detect_and_describe(img2, cfg, device=device)
    p1, p2, ok = match_points(kp1, kp2, cfg.ratio_threshold)
    h, _, _ = ransac_homography(p1, p2, ok, num_hypotheses)
    return composite(
        [np.asarray(img1, np.float32), np.asarray(img2, np.float32)],
        [h.cpu().numpy().astype(np.float64), np.eye(3)],
        device=device,
    )


def stitch_scene(
    images: list[np.ndarray],
    graph,
    cfg=None,
    num_hypotheses: int = 2048,
    seam_aware: bool = True,
    kps: list | None = None,
    device="cuda",
) -> np.ndarray:
    """Multi-image panorama along a STITCH-GRAPH toward its center image.

    All device work (detection for every image, matching + RANSAC for every
    tree edge) is queued before the single host read of the stacked edge
    homographies; the canvas layout is the first thing that needs them.
    """
    from sift_tpu_torch import SiftConfig, detect_and_describe

    cfg = cfg or SiftConfig()
    dev = resolve_device(device)
    with profiling.span("stitch.scene"):
        if kps is None:
            kps = [detect_and_describe(img, cfg, device=dev) for img in images]

        h_edge = solve_edge_homographies(kps, graph, cfg, num_hypotheses)
        return compose_scene(images, graph, h_edge, seam_aware=seam_aware, device=dev)


def solve_edge_homographies(
    kps: list, graph, cfg, num_hypotheses: int = 2048,
    edge_subset: list | None = None,
) -> dict[tuple[int, int], np.ndarray]:
    """Per-BFS-tree-edge homographies {(i, parent): H_i->parent}, float64
    on the host, computed on the keypoints' device.

    ``edge_subset`` restricts the solve (resumable callers cache per edge).
    """
    parents = graph.bfs_parents()
    edge_list = edge_subset if edge_subset is not None else [
        (i, parent) for i, parent in parents.items() if i != graph.center_index
    ]
    with profiling.span("stitch.edges"):
        profiling.count("stitch.edges", len(edge_list))
        hs = []
        for i, parent in edge_list:
            p1, p2, ok = match_points(kps[i], kps[parent], cfg.ratio_threshold)
            h, _, _ = ransac_homography(p1, p2, ok, num_hypotheses)
            hs.append(h)
        # Single device -> host read for all edge homographies.
        with profiling.span("stitch.sync.homographies"):
            hs_host = (torch.stack(hs).cpu().numpy().astype(np.float64) if hs
                       else np.zeros((0, 3, 3)))
    return {e: hs_host[n] for n, e in enumerate(edge_list)}


def chain_to_center(graph, h_edge: dict) -> dict[int, np.ndarray]:
    """{i: H_i->center} by chaining edge homographies along the BFS tree:
    H_i->center = H_parent->center @ H_i->parent."""
    parents = graph.bfs_parents()
    h_center: dict[int, np.ndarray] = {graph.center_index: np.eye(3)}

    def resolve(i: int) -> np.ndarray:
        if i in h_center:
            return h_center[i]
        parent = parents[i]
        h = resolve(parent) @ h_edge[(i, parent)]
        h_center[i] = h
        return h

    for i in parents:
        resolve(i)
    return h_center


def compose_scene(
    images: list[np.ndarray], graph, h_edge: dict, seam_aware: bool = True,
    device="cuda",
) -> np.ndarray:
    """Chain edge homographies toward the center image and composite."""
    h_center = chain_to_center(graph, h_edge)

    # Apply the center rotation about the center image's midpoint.
    ang = graph.center_rotation
    ci = graph.center_index
    hh, ww = images[ci].shape[0], images[ci].shape[1]
    cx, cy = (ww - 1) / 2.0, (hh - 1) / 2.0
    c, s = math.cos(ang), math.sin(ang)
    rot = (
        np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]])
        @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        @ np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]])
    )

    order = sorted(h_center)
    return composite(
        [np.asarray(images[i], np.float32) for i in order],
        [rot @ h_center[i] for i in order],
        seam_aware=seam_aware,
        device=device,
    )


def composite(
    images: list[np.ndarray],
    homographies: list[np.ndarray],
    seam_aware: bool = True,
    max_canvas: int = 8192,
    max_multiband_pixels: int = 24_000_000,
    device="cuda",
) -> np.ndarray:
    """Gain-compensated seam-aware composite (feather fallback when off).

    ``max_multiband_pixels`` bounds the canvas the Laplacian pyramids stay
    resident for; larger canvases feather-blend (with gains).
    """
    if not seam_aware:
        return blend_warped(images, homographies, max_canvas=max_canvas, device=device)
    from sift_tpu_torch.models.blend import estimate_gains, multiband_blend

    out_h, out_w, t = _canvas_layout(images, homographies, max_canvas)
    gains = estimate_gains(
        images, [t @ np.asarray(h) for h in homographies], out_h, out_w, device=device
    )
    return multiband_blend(
        images, homographies, gains=gains, max_canvas=max_canvas,
        max_pixels=max_multiband_pixels, device=device,
    )
