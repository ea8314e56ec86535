"""Orientation assignment (src/sift.cpp:447-533).

Port of ``sift_tpu/models/orient.py::orient_all``.  The reference's dynamic
radius round(3 * 1.5 * size) is bounded (refined layers stay in
[1, intervals] and |offset| < 0.5), so every keypoint reads one fixed
(2R+3)^2 patch and the radius and image-border skips become masks.  The
36-bin histogram is a masked one-hot contraction; the reference's in-place
sequential smoothing is reproduced bin by bin on the (bins, lanes) layout.

Only valid lanes are computed (invalid lanes would contribute nothing).
Outside the float64 parity profile each lane reads the smallest window of
the radius classes (11, 13, R) that covers its own radius
(``gather.by_radius_class``); float64 reads the one (2R+3)^2 window, as the
JAX package does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sift_tpu_torch.config import M_PI2, ORI_SMOOTH_ITERATIONS, SiftConfig
from sift_tpu_torch.ops.gather import (
    build_multi_rows,
    by_radius_class,
    class_of,
    gather_patches,
    lut,
    radius_classes,
)
from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.keypoints import Keypoints
from sift_tpu_torch.utils.numerics import round_half_away, xdiv


def max_size_octave(cfg: SiftConfig) -> float:
    """Upper bound on keypoint size in octave coordinates."""
    return cfg.init_sigma * math.pow(2, (cfg.intervals + 0.5) / cfg.intervals)


def ori_radius_bound(cfg: SiftConfig) -> int:
    """Static bound for round(3 * ori_sigma_factor * size) (src/sift.cpp:463)."""
    return int(math.ceil(3.0 * cfg.ori_sigma_factor * max_size_octave(cfg) + 0.5))


def ori_radius_classes(cfg: SiftConfig, classes: bool = True) -> list[int]:
    """The orientation windows' radii (the JAX package's dispatch classes,
    sift_tpu/models/orient.py:172); float64, or ``classes=False``, runs
    the worst-case window alone."""
    r_max = ori_radius_bound(cfg)
    if not classes or cfg.dtype == torch.float64:
        return [r_max]
    return radius_classes((11, 13), r_max)


def _histograms(sp, img, oct_sel, layer_c, xc, yc, x, y, radius, edenom,
                wl, hl, nb: int, r: int, fast: bool):
    """(L, nb) raw orientation histograms of L valid lanes."""
    dtype = edenom.dtype
    dev = edenom.device
    p = 2 * r + 3
    ii = torch.arange(-r, r + 1, device=dev)
    ig = ii[None, :]  # x offsets (columns)
    jg = ii[:, None]  # y offsets (rows)
    patches = gather_patches(sp, img, oct_sel, layer_c, yc - r - 1, xc - r - 1, p)
    dx = patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2]
    dy = patches[:, :-2, 1:-1] - patches[:, 2:, 1:-1]
    magnitude = torch.sqrt(dx * dx + dy * dy)
    angle = torch.atan2(dy, dx)
    if fast:
        # exp(-(i^2 + j^2)/d) is separable (the JAX float32 arithmetic).
        g1 = torch.exp(-(ii * ii).to(dtype)[None, :] / edenom[:, None])
        w_exp = g1[:, :, None] * g1[:, None, :]
    else:
        w_exp = torch.exp(
            -(ig * ig + jg * jg).to(dtype)[None] / edenom[:, None, None]
        )
    e = (slice(None), None, None)
    in_radius = (ig.abs() <= radius[e]) & (jg.abs() <= radius[e])
    in_img = (
        (x[e] + ig - 1 >= 0) & (x[e] + ig + 1 <= wl[e] - 1)
        & (y[e] + jg - 1 >= 0) & (y[e] + jg + 1 <= hl[e] - 1)
    )
    h_idx = round_half_away(xdiv(nb * (angle + math.pi), M_PI2)).to(torch.int64)
    h_idx = torch.where(h_idx < nb, h_idx, torch.zeros_like(h_idx))  # src/sift.cpp:490
    contrib = torch.where(in_radius & in_img, w_exp * magnitude, torch.zeros_like(magnitude))
    onehot = F.one_hot(h_idx.reshape(len(x), -1), nb).to(dtype)
    return torch.bmm(contrib.reshape(len(x), 1, -1), onehot)[:, 0]


# Position of the radius among ``_lane_args``'s per-lane arguments.
_RADIUS = 7


def _lane_args(sp, kp: Keypoints, cfg: SiftConfig, octave_of_volume):
    """The valid lanes of ``kp`` (flat indices) and their arguments of
    ``_histograms``: (img, oct_sel, layer_c, xc, yc, x, y, radius, edenom,
    wl, hl)."""
    n = kp.x.shape[1]
    octaves = len(sp.shapes)
    with profiling.span("sift.sync.lanes"):
        lanes = kp.valid.reshape(-1).nonzero()[:, 0]
    img = lanes // n

    def pick(a):
        return a.reshape(-1)[lanes]

    kx, ky, ksize, koct, klayer = (pick(a) for a in (kp.x, kp.y, kp.size, kp.octave, kp.layer))
    oov = octave_of_volume or tuple(range(octaves))
    oct_sel = (koct - oov[0]).clamp(0, octaves - 1)
    pow_denom = lut([1.0 / math.pow(2, o) for o in oov], oct_sel, kp.x.dtype)
    x = round_half_away(kx * pow_denom).to(torch.int64)  # src/sift.cpp:458
    y = round_half_away(ky * pow_denom).to(torch.int64)
    scale = cfg.ori_sigma_factor * (ksize * pow_denom)
    radius = round_half_away(3.0 * scale).to(torch.int64)  # src/sift.cpp:463
    edenom = 2.0 * scale * scale
    wl = sp.table(2, oct_sel)
    hl = sp.table(1, oct_sel)
    layer_c = klayer.long().clamp(0, sp.shapes[0][0] - 1)
    xc = torch.minimum(x.clamp_min(0), wl - 1)
    yc = torch.minimum(y.clamp_min(0), hl - 1)
    return lanes, (img, oct_sel, layer_c, xc, yc, x, y, radius, edenom, wl, hl)


def class_counts(sp, kp: Keypoints, cfg: SiftConfig, classes: bool = True) -> list[int]:
    """Valid lanes of ``kp`` per window of ``ori_radius_classes``."""
    radii = ori_radius_classes(cfg, classes)
    radius = _lane_args(sp, kp, cfg, None)[1][_RADIUS]
    return torch.bincount(class_of(radius, radii), minlength=len(radii)).tolist()


def orient_all(sp, kp: Keypoints, cfg: SiftConfig,
               octave_of_volume: tuple[int, ...] | None = None, classes: bool = True):
    """Orientation candidates of a (B, n) keypoint buffer in initial-image
    coordinates.  Returns (candidates (B, n * slots) in input-image
    coordinates, in (lane, bin) order with a validity mask, and max_peaks:
    the most peaks any valid keypoint had; > slots means candidates were
    dropped).  ``octave_of_volume``: the true octave of each volume of
    ``sp`` when it does not start at octave 0 (the staged path's
    one-octave spaces).  ``classes=False``: every lane in the worst-case
    window (``ori_radius_classes``)."""
    bsz, n = kp.x.shape
    dtype = kp.x.dtype
    dev = kp.x.device
    nb = cfg.num_bins
    slots = cfg.ori_cand_slots
    fast = dtype != torch.float64

    lanes, args = _lane_args(sp, kp, cfg, octave_of_volume)
    chunk = 2048 if dev.type == "cuda" else 256  # lanes per one-hot contraction
    if len(lanes):
        hist = by_radius_class(
            args[_RADIUS], ori_radius_classes(cfg, classes), chunk, args,
            lambda a, r: _histograms(sp, *a, nb, r, fast), stage="orient")
    else:
        hist = torch.zeros((0, nb), dtype=dtype, device=dev)

    # In-place circular smoothing, twice (src/sift.cpp:496-504): updated
    # bins feed later ones, exactly as the reference's loop.
    hist_t = list(hist.T.contiguous().unbind(0))
    for _ in range(ORI_SMOOTH_ITERATIONS):
        for i in range(nb):
            hist_t[i] = (
                0.25 * hist_t[(i - 1) % nb] + 0.5 * hist_t[i]
            ) + 0.25 * hist_t[(i + 1) % nb]
    hist = torch.stack(hist_t, dim=1)

    # Peak detection + parabolic interpolation (src/sift.cpp:506-518).
    max_peak = hist.amax(dim=1, keepdim=True)
    h0 = torch.roll(hist, 1, dims=1)
    h2 = torch.roll(hist, -1, dims=1)
    is_peak = (hist > h0) & (hist > h2) & (hist > cfg.peak_ratio * max_peak)
    bin_i = torch.arange(nb, dtype=dtype, device=dev)[None, :]
    denom = (h0 - 2 * hist) + h2
    denom_safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    interp = bin_i + 0.5 * (h0 - h2) / denom_safe
    interp = torch.fmod(interp + nb, float(nb))
    ori = xdiv(M_PI2 * interp, float(nb))
    ori = torch.fmod(ori + M_PI2, M_PI2)

    # First ``slots`` peaks in bin order: the (lane, slot) candidate order
    # equals the (lane, bin) order of the valid candidates.
    counts = is_peak.sum(dim=1)
    max_peaks = counts.max() if len(lanes) else counts.new_zeros(())
    bidx = torch.arange(nb, device=dev)[None, :]
    order = torch.argsort(
        torch.where(is_peak, bidx, torch.full_like(bidx, nb)), dim=1, stable=True
    )[:, :slots]
    ori = torch.gather(ori, 1, order)

    halve = 0.5 if cfg.double_image_size else 1.0
    pori = torch.zeros((bsz * n, slots), dtype=dtype, device=dev)
    pori[lanes] = ori
    cvalid = torch.zeros((bsz * n, slots), dtype=torch.bool, device=dev)
    cvalid[lanes] = torch.arange(slots, device=dev)[None, :] < counts[:, None]

    def rep(a):
        return a.repeat_interleave(slots, dim=-1)

    cand = Keypoints(
        x=rep(kp.x * halve), y=rep(kp.y * halve), octave=rep(kp.octave),
        layer=rep(kp.layer), size=rep(kp.size * halve),
        pori=pori.reshape(bsz, n * slots),
        desc=torch.zeros((bsz, n * slots, 128), dtype=torch.uint8, device=dev),
        valid=cvalid.reshape(bsz, n * slots),
    )
    return cand, max_peaks.to(torch.int32)


def orient_octave_keypoints(gauss: torch.Tensor, kp: Keypoints, octave: int, cfg: SiftConfig):
    """The staged path's one-octave orientation: gauss (S, H, W), kp (n,)
    lanes of octave ``octave`` -> (candidates (n * slots,), max_peaks),
    gathered from the octave's row-major twin rows as in the JAX package
    (kernel H in float32 on the card)."""
    cand, max_peaks = orient_all(
        build_multi_rows([gauss]),
        kp.map(lambda a: a[None]), cfg, octave_of_volume=(octave,),
    )
    return cand.map(lambda a: a[0]), max_peaks
