"""128-D gradient-histogram descriptors (src/sift.cpp:541-682).

Port of ``sift_tpu/models/descriptor.py::compute_descriptors_all``: the
reference's rotated sample loop with trilinear scatter-add becomes, per
keypoint, 2-sparse one-hot factors along the row, column and orientation
bins whose contraction is the histogram, hist[r, c, o] = sum_s R[s, r] *
C[s, c] * O[s, o], keeping the reference's product order
((magnitude * f_r) * f_c) * f_o.  Only valid lanes are computed (invalid
lanes' descriptors are zero, as in the JAX package).  Outside the
float64 parity profile each lane reads the smallest window of the radius
classes (20, 24, 28, 32, 36, R) that covers its own radius
(``gather.by_radius_class``); float64 reads the worst-case window alone.
"""

from __future__ import annotations

import math

import torch

from sift_tpu_torch.config import (
    DESC_HIST_BINS,
    DESC_HIST_WIDTH,
    DESC_MAGNITUDE_THR,
    INT_DESCR_FCTR,
    M_PI2,
    SiftConfig,
)
from sift_tpu_torch.models.orient import max_size_octave
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


def desc_radius_bound(cfg: SiftConfig) -> int:
    """Static bound for the descriptor radius (src/sift.cpp:636-639)."""
    hw = cfg.desc_scale_factor * max_size_octave(cfg)
    return int(math.ceil(hw * 0.5 * math.sqrt(2.0) * (DESC_HIST_WIDTH + 1.0) + 1.0))


def desc_radius_classes(cfg: SiftConfig, classes: bool = True) -> list[int]:
    """The descriptor windows' radii (the JAX package's dispatch classes,
    sift_tpu/models/descriptor.py:241); float64, or ``classes=False``, runs
    the worst-case window alone."""
    r_max = desc_radius_bound(cfg)
    if not classes or cfg.dtype == torch.float64:
        return [r_max]
    return radius_classes((20, 24, 28, 32, 36), r_max)


def _descriptors(sp, img, oct_sel, layer_c, xc, yc, x, y, radius, hw, ca, sa,
                 pori, wl, hl, r: int, fast: bool):
    """(L, 128) uint8 descriptors of L valid lanes."""
    dtype = hw.dtype
    dev = hw.device
    nc = hw.shape[0]
    offs = torch.arange(-r, r + 1, device=dev)
    rg = offs[:, None].to(dtype)  # (s, 1) row = y offset
    cg = offs[None, :].to(dtype)  # (1, s) col = x offset
    e = (slice(None), None, None)
    patches = gather_patches(sp, img, oct_sel, layer_c, yc - r - 1, xc - r - 1, 2 * r + 3)
    dx = patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2]
    dy = patches[:, :-2, 1:-1] - patches[:, 2:, 1:-1]

    if fast:  # the JAX float32 arithmetic: reciprocal-multiply
        inv_hw = (1.0 / hw)[e]
        row_rot = (cg * sa[e] + rg * ca[e]) * inv_hw
        col_rot = (cg * ca[e] - rg * sa[e]) * inv_hw
    else:
        row_rot = (cg * sa[e] + rg * ca[e]) / hw[e]
        col_rot = (cg * ca[e] - rg * sa[e]) / hw[e]
    row_bin = (row_rot + DESC_HIST_WIDTH // 2) - 0.5
    col_bin = (col_rot + DESC_HIST_WIDTH // 2) - 0.5

    new_x = x[e] + offs[None, None, :]
    new_y = y[e] + offs[None, :, None]
    mask = (
        (row_bin > -1.0) & (row_bin < DESC_HIST_WIDTH)
        & (col_bin > -1.0) & (col_bin < DESC_HIST_WIDTH)
        & (new_x > 0) & (new_x < wl[e] - 1)
        & (new_y > 0) & (new_y < hl[e] - 1)
        & (offs.abs()[None, None, :] <= radius[e])
        & (offs.abs()[None, :, None] <= radius[e])
    )

    magnitude = torch.sqrt(dx * dx + dy * dy)
    angle = torch.atan2(dy, dx) - pori[e]
    angle = torch.fmod(torch.fmod(angle, M_PI2) + M_PI2, M_PI2)
    ori_bin = angle * (DESC_HIST_BINS / M_PI2)
    exp_denom = 0.5 * DESC_HIST_WIDTH * DESC_HIST_WIDTH
    if fast:
        # Rotation keeps the norm, so the gaussian weight is separable.
        o2 = (offs * offs).to(dtype)
        coef = xdiv((1.0 / hw) * (1.0 / hw), exp_denom)[:, None]
        g1 = torch.exp(-o2[None, :] * coef)
        weight = g1[:, :, None] * g1[:, None, :]
    else:
        weight = torch.exp(xdiv(-(row_rot * row_rot + col_rot * col_rot), exp_denom))
    m = torch.where(mask, magnitude * weight, torch.zeros_like(magnitude))

    row_bin, col_bin, ori_bin, m = (a.reshape(nc, -1) for a in (row_bin, col_bin, ori_bin, m))
    base_r, base_c, base_o = torch.floor(row_bin), torch.floor(col_bin), torch.floor(ori_bin)
    d_r, d_c, d_o = row_bin - base_r, col_bin - base_c, ori_bin - base_o
    base_r, base_c, base_o = (a.to(torch.int64)[..., None] for a in (base_r, base_c, base_o))
    rr = torch.arange(DESC_HIST_WIDTH, device=dev)
    oo = torch.arange(DESC_HIST_BINS, device=dev)

    fr = (m * (1.0 - d_r))[..., None] * (base_r == rr) + (m * d_r)[..., None] * (
        (base_r + 1) == rr
    )
    fc = (1.0 - d_c)[..., None] * (base_c == rr) + d_c[..., None] * ((base_c + 1) == rr)
    fo = (1.0 - d_o)[..., None] * ((base_o % DESC_HIST_BINS) == oo) + d_o[..., None] * (
        ((base_o + 1) % DESC_HIST_BINS) == oo
    )
    rc = fr[:, :, :, None] * fc[:, :, None, :]  # (nc, S2, 4, 4)
    hist = torch.bmm(rc.reshape(nc, -1, 16).transpose(1, 2), fo)  # (nc, 16, 8)
    return hist_to_desc(hist.reshape(nc, 128))


def hist_to_desc(hist: torch.Tensor) -> torch.Tensor:
    """convert_hist_to_desc (src/sift.cpp:576-603): L2 normalize, clip at
    0.2, renormalize, floor(512 * v) clamped to 255; an all-zero histogram
    gives zeros (the reference has no epsilon there)."""

    def inv_norm(a):
        norm = torch.sqrt((a * a).sum(dim=1, keepdim=True))
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        return torch.where(norm > 0, 1.0 / safe, torch.zeros_like(norm))

    h = (hist * inv_norm(hist)).clamp_max(DESC_MAGNITUDE_THR)
    val = torch.floor(INT_DESCR_FCTR * h * inv_norm(h)).to(torch.int32)
    return val.clamp_max(255).to(torch.uint8)


# Position of the radius among ``_lane_args``'s per-lane arguments.
_RADIUS = 7


def _lane_args(sp, kp: Keypoints, cfg: SiftConfig, octave_of_volume):
    """The valid lanes of ``kp`` (flat indices) and their arguments of
    ``_descriptors``: (img, oct_sel, layer_c, xc, yc, x, y, radius, hw,
    cos, sin, pori, wl, hl)."""
    n = kp.x.shape[1]
    dtype = kp.x.dtype
    octaves = len(sp.shapes)
    with profiling.span("sift.sync.lanes"):
        lanes = kp.valid.reshape(-1).nonzero()[:, 0]
    img = lanes // n
    kx, ky, ksize, kpori, koct, klayer = (
        a.reshape(-1)[lanes] for a in (kp.x, kp.y, kp.size, kp.pori, kp.octave, kp.layer)
    )
    oov = octave_of_volume or tuple(range(octaves))
    oct_sel = (koct - oov[0]).clamp(0, octaves - 1)
    # src/sift.cpp:620-625: coordinates were already halved when doubling.
    shift = 1 if cfg.double_image_size else 0
    pow_denom = lut([1.0 / math.pow(2, o - shift) for o in oov], oct_sel, dtype)
    x = (kx * pow_denom).to(torch.int64)  # C int truncation (src/sift.cpp:623)
    y = (ky * pow_denom).to(torch.int64)
    size = ksize * pow_denom
    hist_width = cfg.desc_scale_factor * size
    hw_safe = torch.where(hist_width > 0, hist_width, torch.ones_like(hist_width))
    tmp_radius = round_half_away(
        hist_width * 0.5 * math.sqrt(2.0) * (DESC_HIST_WIDTH + 1.0) + 0.5
    )
    diag = lut([math.sqrt(s[2] * s[2] + s[1] * s[1]) for s in sp.shapes], oct_sel, dtype)
    radius = torch.minimum(tmp_radius, diag).to(torch.int64)
    wl = sp.table(2, oct_sel)
    hl = sp.table(1, oct_sel)
    layer_c = klayer.long().clamp(0, sp.shapes[0][0] - 1)
    xc = torch.minimum(x.clamp_min(0), wl - 1)
    yc = torch.minimum(y.clamp_min(0), hl - 1)
    cos_a, sin_a = torch.cos(kpori), torch.sin(kpori)
    return lanes, (img, oct_sel, layer_c, xc, yc, x, y, radius, hw_safe, cos_a, sin_a, kpori,
                   wl, hl)


def class_counts(sp, kp: Keypoints, cfg: SiftConfig, classes: bool = True) -> list[int]:
    """Valid lanes of ``kp`` per window of ``desc_radius_classes``."""
    radii = desc_radius_classes(cfg, classes)
    radius = _lane_args(sp, kp, cfg, None)[1][_RADIUS]
    return torch.bincount(class_of(radius, radii), minlength=len(radii)).tolist()


def compute_descriptors_all(sp, kp: Keypoints, cfg: SiftConfig,
                            octave_of_volume: tuple[int, ...] | None = None,
                            classes: bool = True) -> torch.Tensor:
    """Descriptors of a (B, n) post-dedup keypoint buffer in input-image
    coordinates: (B, n, 128) uint8, zero on invalid lanes.
    ``octave_of_volume``: as in ``orient_all``; ``classes=False``: every
    lane in the worst-case window (``desc_radius_classes``)."""
    bsz, n = kp.x.shape
    dev = kp.x.device
    fast = kp.x.dtype != torch.float64
    lanes, args = _lane_args(sp, kp, cfg, octave_of_volume)
    chunk = 512 if dev.type == "cuda" else 64  # lanes per window batch
    desc = torch.zeros((bsz * n, 128), dtype=torch.uint8, device=dev)
    if len(lanes):
        desc[lanes] = by_radius_class(
            args[_RADIUS], desc_radius_classes(cfg, classes), chunk, args,
            lambda a, r: _descriptors(sp, *a, r, fast), stage="describe")
    return desc.reshape(bsz, n, 128)


def compute_octave_descriptors(gauss: torch.Tensor, kp: Keypoints, octave: int,
                               cfg: SiftConfig) -> torch.Tensor:
    """The staged path's one-octave descriptors: gauss (S, H, W), kp (n,)
    lanes of octave ``octave`` -> (n, 128) uint8, gathered from the octave's
    row-major twin rows as in the JAX package (kernel H in float32 on the
    card)."""
    return compute_descriptors_all(
        build_multi_rows([gauss]),
        kp.map(lambda a: a[None]), cfg, octave_of_volume=(octave,),
    )[0]
