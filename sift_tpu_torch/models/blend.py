"""Seam-aware panorama compositing: global offsets, gain compensation,
multiband blending (the JAX package's ``models/blend.py``).

The standard Brown & Lowe (IJCV 2007) compositing stack:

- ``solve_global_offsets``: least-squares 2-D offsets over all match-graph
  edges (the chain-toward-center tree integrates per-edge noise; the global
  solve distributes it), a tiny host-side solve.
- ``estimate_gains``: per-image photometric gains from pairwise overlap
  means (Brown & Lowe section 6), measured on a low-resolution warp of the
  actual canvas layout.
- ``multiband_blend``: Burt-Adelson Laplacian-pyramid blending over
  argmax-weight seam masks.  Each canvas pixel's high frequencies come from
  exactly one image (no ghosting); low frequencies blend over progressively
  wider regions (no visible seams).  Two passes over the image stack, each
  a Python loop that accumulates on the device (the JAX package's
  ``lax.scan``): the seam assignment, then the per-level sums.

Spans (``utils/profiling``): ``stitch.gains`` around ``estimate_gains``
(its host read ``stitch.sync.gains``), ``stitch.blend`` around
``multiband_blend``, uploads ``stitch.sync.upload``; the multiband pass
counts ``blend.px_warped`` / ``blend.px_footprint`` as
``stitch.count_blend`` says.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sift_tpu_torch.models.stitch import warp_accumulate
from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.numerics import resolve_device

# --------------------------------------------------------------------------
# Global offset adjustment (cylindrical / translation panoramas)
# --------------------------------------------------------------------------


def solve_global_offsets(
    n_images: int,
    center: int,
    edges: list[tuple[int, int]],
    translations: list[np.ndarray],
    weights: list[float] | None = None,
) -> np.ndarray:
    """Least-squares per-image 2-D offsets from per-edge translations.

    ``translations[k]`` maps image ``edges[k][0]`` coords into
    ``edges[k][1]`` coords (o_i - o_j = t_k); the center image is gauged to
    the origin.  Weighted by match inlier counts when given.  Returns
    (n_images, 2) offsets.
    """
    if not edges:
        return np.zeros((n_images, 2))
    w = np.sqrt(np.asarray(weights if weights is not None else [1.0] * len(edges),
                           np.float64).clip(min=1e-3))
    a = np.zeros((len(edges) + 1, n_images))
    b = np.zeros((len(edges) + 1, 2))
    for k, ((i, j), t) in enumerate(zip(edges, translations)):
        a[k, i] = w[k]
        a[k, j] = -w[k]
        b[k] = w[k] * np.asarray(t, np.float64)
    gauge = max(10.0 * w.max(), 1.0)
    a[len(edges), center] = gauge  # pin o_center = 0
    sol, *_ = np.linalg.lstsq(a, b, rcond=None)
    return sol - sol[center]  # exact gauge


# --------------------------------------------------------------------------
# Gain compensation
# --------------------------------------------------------------------------


def estimate_gains(
    images: list[np.ndarray],
    homographies: list[np.ndarray],
    out_h: int,
    out_w: int,
    scale: float = 0.25,
    sigma_n: float = 10.0,
    sigma_g: float = 0.1,
    min_overlap: int = 64,
    device="cuda",
) -> np.ndarray:
    """Brown & Lowe gain compensation from low-resolution overlap means.

    ``homographies[i]`` maps image i pixels -> canvas (same convention as
    ``stitch.blend_warped``).  Warps every image onto a ``scale``-sized
    canvas, measures mean luminance over every pairwise overlap, and solves
    the normal equations of
    ``sum_ij N_ij [ (g_i I_ij - g_j I_ji)^2 / sigma_n^2
                    + (1 - g_i)^2 / sigma_g^2 ]``.
    Returns (N,) gains (all ones when there are no usable overlaps).
    """
    with profiling.span("stitch.gains"):
        return _gains(images, homographies, out_h, out_w, scale, sigma_n, sigma_g,
                      min_overlap, device)


def _gains(images, homographies, out_h, out_w, scale, sigma_n, sigma_g, min_overlap,
           device):
    n = len(images)
    lum, cov = _lowres_luminance(images, homographies, out_h, out_w, scale, device)
    # Every pair's overlap size and luminance sums at once, as two Gram
    # matrices on the device (one host read): N[i, j] = |cov_i & cov_j|,
    # S[i, j] = the sum of lum_i over that overlap.
    m = cov.reshape(n, -1).to(torch.float64)
    lm = lum.reshape(n, -1).to(torch.float64) * m
    with profiling.span("stitch.sync.gains"):
        overlap, sums = torch.stack([m @ m.T, lm @ m.T]).cpu().numpy()

    a = np.zeros((n, n))
    b = np.zeros(n)
    seen = False
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            n_ij = int(overlap[i, j])
            if n_ij < min_overlap:
                continue
            seen = True
            ibar_i = sums[i, j] / n_ij
            ibar_j = sums[j, i] / n_ij
            # d/dg_i of N_ij [ (g_i I_ij - g_j I_ji)^2/s_n^2 + (1-g_i)^2/s_g^2 ]
            a[i, i] += n_ij * (ibar_i * ibar_i / sigma_n**2 + 1.0 / sigma_g**2)
            a[i, j] -= n_ij * ibar_i * ibar_j / sigma_n**2
            b[i] += n_ij / sigma_g**2
    if not seen:
        return np.ones(n)
    gains = np.linalg.solve(a + 1e-9 * np.eye(n), b)
    return np.clip(gains, 0.5, 2.0)


def _lowres_luminance(images, homographies, out_h, out_w, scale, device="cuda"):
    """Per-image (luminance, coverage), (N, lh, lw) each, on a
    ``scale``-sized canvas, on the device."""
    dev = resolve_device(device)
    lh = max(int(round(out_h * scale)), 8)
    lw = max(int(round(out_w * scale)), 8)
    s = np.diag([lw / out_w, lh / out_h, 1.0])
    accs, wgts = [], []
    for img, h in zip(images, homographies):
        h_inv = np.linalg.inv(s @ np.asarray(h, np.float64)).astype(np.float32)
        with profiling.span("stitch.sync.upload"):
            img_d = torch.from_numpy(np.asarray(img, np.float32)).to(dev)
            h_inv_d = torch.from_numpy(h_inv).to(dev)
        acc, wgt = warp_accumulate(img_d, h_inv_d, lh, lw)
        accs.append(acc)
        wgts.append(wgt)
    wgts = torch.stack(wgts)
    return torch.stack(accs).mean(-1) / torch.clamp(wgts, min=1e-8), wgts > 0


def overlap_consistency(
    images: list[np.ndarray],
    homographies: list[np.ndarray],
    out_h: int,
    out_w: int,
    scale: float = 0.5,
    min_overlap: int = 64,
    device="cuda",
) -> float:
    """Alignment-quality metric: mean |lum_i - lum_j| over pairwise overlaps.

    Measured pre-blend on the actual canvas layout; low values mean the
    registered images agree where they overlap (ghosting-free composites),
    high values mean misalignment or exposure drift.  Returns 0 when no
    pair overlaps.
    """
    means, masks = (t.cpu().numpy() for t in _lowres_luminance(
        images, homographies, out_h, out_w, scale, device))
    tot, cnt = 0.0, 0
    for i in range(len(images)):
        for j in range(i + 1, len(images)):
            ov = masks[i] & masks[j]
            n_ij = int(ov.sum())
            if n_ij < min_overlap:
                continue
            tot += float(np.abs(means[i][ov] - means[j][ov]).sum())
            cnt += n_ij
    return tot / cnt if cnt else 0.0


# --------------------------------------------------------------------------
# Multiband (Laplacian pyramid) blending
# --------------------------------------------------------------------------

_BINOMIAL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _blur5(x: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur of (H, W) or (H, W, C), zero padding
    with the kernel renormalized by the blurred ones at the borders (so
    constants stay constant)."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, :, None]
    ones = torch.ones_like(x[:, :, :1])

    def conv1d(v, axis):
        pad = [0, 0, 0, 0, 0, 0]  # F.pad order: last axis first
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 2
        vp = F.pad(v, pad)
        n = v.shape[axis]
        out = 0.0
        for t, k in enumerate(_BINOMIAL):
            out = out + k * vp.narrow(axis, t, n)
        return out

    num = conv1d(conv1d(x, 0), 1)
    den = conv1d(conv1d(ones, 0), 1)
    out = num / den
    return out[:, :, 0] if squeeze else out


def _down(x: torch.Tensor) -> torch.Tensor:
    return _blur5(x)[::2, ::2]


def _up(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Bilinear resize of (H, W) or (H, W, C) to (th, tw): half-pixel
    centers, edge samples clamped (``jax.image.resize(.., "bilinear")`` for
    the exact 2x upsampling the pyramid uses)."""
    chw = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=(th, tw), mode="bilinear", align_corners=False,
                        antialias=False)[0]
    return out[0] if x.dim() == 2 else out.permute(1, 2, 0)


def _multiband_scan(stack, h_invs, gains, out_h: int, out_w: int, bands: int):
    """Seam-masked Laplacian blend of a same-shape image stack.

    ``stack``: (N, H, W, C) source images; ``h_invs``: (N, 3, 3)
    canvas->image inverse homographies; ``gains``: (N,).  Canvas dims must
    be multiples of 2^(bands-1).  Returns (out_h, out_w, C), on the stack's
    device.
    """
    c = stack.shape[-1]
    f32, dev = torch.float32, stack.device

    # Pass A: per-pixel argmax of the feather weight = seam assignment.
    best_w = torch.zeros((out_h, out_w), dtype=f32, device=dev)
    best_i = torch.full((out_h, out_w), -1, dtype=torch.int32, device=dev)
    for idx in range(stack.shape[0]):
        _, wgt = warp_accumulate(stack[idx], h_invs[idx], out_h, out_w)
        better = wgt > best_w
        best_w = torch.where(better, wgt, best_w)
        best_i = torch.where(better, torch.full_like(best_i, idx), best_i)

    # Pass B: accumulate mask-weighted Laplacian levels.
    shapes = [(out_h, out_w)]
    for _ in range(bands - 1):
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    nums = [torch.zeros((*s, c), dtype=f32, device=dev) for s in shapes]
    dens = [torch.zeros(s, dtype=f32, device=dev) for s in shapes]
    for idx in range(stack.shape[0]):
        acc, wgt = warp_accumulate(stack[idx], h_invs[idx], out_h, out_w)
        val = gains[idx] * acc / torch.clamp(wgt, min=1e-8)[:, :, None]
        m = ((best_i == idx) & (wgt > 0)).to(f32)

        # Normalized-convolution pyramid: dividing each level by the
        # downsampled coverage extrapolates the image smoothly past its
        # footprint, so coarse levels never pull in the zeros outside it
        # (black halos at seams near coverage edges); in full-coverage
        # interior cov == 1 and this reduces to the plain pyramid.
        cov = (wgt > 0).to(f32)
        gv, gc, gm = [val], [cov], [m]
        for _ in range(bands - 1):
            cn = _down(gc[-1])
            gv.append(_down(gv[-1] * gc[-1][:, :, None])
                      / torch.clamp(cn, min=1e-6)[:, :, None])
            gc.append(cn)
            gm.append(_down(gm[-1]))
        for lvl in range(bands):
            if lvl < bands - 1:
                lap = gv[lvl] - _up(gv[lvl + 1], *shapes[lvl])
            else:
                lap = gv[lvl]
            nums[lvl] = nums[lvl] + gm[lvl][:, :, None] * lap
            dens[lvl] = dens[lvl] + gm[lvl]

    out = nums[-1] / torch.clamp(dens[-1], min=1e-8)[:, :, None]
    for lvl in range(bands - 2, -1, -1):
        out = _up(out, *shapes[lvl]) + (
            nums[lvl] / torch.clamp(dens[lvl], min=1e-8)[:, :, None]
        )
    return torch.where((best_w > 0)[:, :, None], out, torch.zeros_like(out))


def multiband_blend(
    images: list[np.ndarray],
    homographies: list[np.ndarray],
    gains: np.ndarray | None = None,
    bands: int = 5,
    max_canvas: int = 8192,
    max_pixels: int = 24_000_000,
    device="cuda",
) -> np.ndarray:
    """Seam-aware multiband composite (drop-in for ``stitch.blend_warped``).

    Canvas layout matches ``blend_warped`` (warped-corner bounds, clamped).
    Falls back to feather strips when the canvas exceeds ``max_pixels``
    (full-pyramid residency) or when source shapes differ.
    """
    from sift_tpu_torch.models.stitch import _canvas_layout, blend_warped, count_blend

    dev = resolve_device(device)
    with profiling.span("stitch.blend"):
        out_h, out_w, t = _canvas_layout(images, homographies, max_canvas)
        same_shape = len({img.shape for img in images}) == 1
        if out_h * out_w > max_pixels or not same_shape:
            # Feather fallback keeps the gain compensation already estimated.
            return blend_warped(
                images, homographies, max_canvas=max_canvas, gains=gains, device=dev
            )

        # Pad up so every pyramid level halves cleanly; crop at the end.
        mult = 1 << (bands - 1)
        ph = -(-out_h // mult) * mult
        pw = -(-out_w // mult) * mult
        # each image is warped over the padded canvas twice (seams, levels)
        count_blend(images, homographies, t, out_h, out_w, ph * pw, passes=2,
                    max_canvas=max_canvas)

        h_invs = np.stack(
            [np.linalg.inv(t @ np.asarray(h)) for h in homographies]
        ).astype(np.float32)
        g = np.ones(len(images), np.float32) if gains is None else np.asarray(
            gains, np.float32
        )
        with profiling.span("stitch.sync.upload"):
            stack = torch.from_numpy(np.stack(images).astype(np.float32)).to(dev)
            h_invs_d = torch.from_numpy(h_invs).to(dev)
            g_d = torch.from_numpy(g).to(dev)
        out = _multiband_scan(stack, h_invs_d, g_d, ph, pw, bands)
        with profiling.span("stitch.sync.strip"):
            out = out.cpu().numpy()
        return np.clip(out[:out_h, :out_w], 0.0, 255.0)
