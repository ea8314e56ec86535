"""Gaussian / DoG pyramid (src/sift.cpp:113-225).

Counterpart of ``sift_tpu/models/pyramid.py``.  ``build_pyramids`` builds
each octave with kernel C (ops/octave_blur.py) when ``cfg.use_octave_kernel``
resolves on, else with the ``_blur`` chain, and seeds the next octave from
gauss layer ``intervals`` decimated by two (src/sift.cpp:195-196).  Every
blur outside kernel C goes through ``_blur``: kernel D (ops/blur_pass.py)
in float32, whose wrapper is the plain blur on a CPU tensor.
``front_pyramids`` builds the front route's pyramids (kernel A per octave),
``front_twin_pyramids`` the front-twin route's: kernel F per octave
writes the gauss twin rows and the cube-packed DoG rows of every octave
into two shared gather buffers, and no plain stack exists.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sift_tpu_torch.config import SiftConfig, gaussian_half_kernel, kernel_on
from sift_tpu_torch.ops.blur import separable_blur
from sift_tpu_torch.ops.blur_pass import separable_blur_kernel
from sift_tpu_torch.ops.color import to_grayscale
from sift_tpu_torch.ops.cube_pack import cube_pack_rows
from sift_tpu_torch.ops.gather import CubeRows, MultiRows, cube_rows_params, twin_strided
from sift_tpu_torch.ops.octave_blur import octave_blur, octave_blur_plain
from sift_tpu_torch.ops.octave_front import octave_front, octave_front_twin
from sift_tpu_torch.ops.resize import downsample_nearest_x2, upsample_bilinear


def _blur(img: torch.Tensor, half_kernel) -> torch.Tensor:
    """One (B, H, W) blur: kernel D's wrapper in float32, the plain blur in
    float64 (the parity profile; the kernels take float32 only, like the
    JAX package's)."""
    if img.dtype == torch.float32:
        return separable_blur_kernel(img.contiguous(), half_kernel)
    return separable_blur(img, half_kernel)


def compute_initial_image(img: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """Grayscale -> optional 2x bilinear upsample -> blur sqrt(sigma^2 - 1)
    (src/sift.cpp:113-126, including the pre-blur without doubling)."""
    gray = to_grayscale(img).to(cfg.dtype)
    if cfg.double_image_size:
        gray = upsample_bilinear(gray, 2, 2)
    sigma = math.sqrt(cfg.init_sigma * cfg.init_sigma - 1)
    return _blur(gray, gaussian_half_kernel(sigma))


def blur_half_kernels(cfg: SiftConfig) -> list[list[float]]:
    """The incremental blurs of one octave (layers 1..S-1)."""
    return [gaussian_half_kernel(s) for s in cfg.gaussian_kernels()[1:]]


def build_pyramids(initial: torch.Tensor, cfg: SiftConfig, octaves: int):
    """initial (B, H, W) -> (gaussians, dogs): per octave, gauss (B, S, H_o,
    W_o) with the seed as layer 0 and DoG (B, S-1, H_o, W_o)."""
    hks = blur_half_kernels(cfg)
    gaussians, dogs = [], []
    img = initial.contiguous()
    for _ in range(octaves):
        if kernel_on(cfg.use_octave_kernel, img.dtype, img.device):
            g, d = octave_blur(img, hks)
        else:
            g, d = octave_blur_plain(img, hks, _blur)
        gaussians.append(g)
        dogs.append(d)
        img = downsample_nearest_x2(g[:, g.shape[1] - 3]).contiguous()
    return gaussians, dogs


def front_pyramids(initial: torch.Tensor, cfg: SiftConfig, octaves: int):
    """initial (B, H, W) -> per-octave lists (gauss (B, S, H_o, W_o), dogs
    (B, S-1, H_o, W_o), masks, counts) from the octave front (kernel A on
    the card): the front route's builder."""
    hks = blur_half_kernels(cfg)
    thr = cfg.extremum_threshold()
    gaussians, dogs, masks, counts = [], [], [], []
    img = initial.contiguous()
    for _ in range(octaves):
        g, d, m, c = octave_front(img, hks, thr, cfg.window_size)
        gaussians.append(g)
        dogs.append(d)
        masks.append(m)
        counts.append(c)
        img = downsample_nearest_x2(g[:, g.shape[1] - 3]).contiguous()
    return gaussians, dogs, masks, counts


@dataclasses.dataclass(frozen=True)
class FrontTwinPlan:
    """The layout of the front-twin route's two gather buffers
    (``models/sift.front_twin_plan`` computes it as the JAX package does).

    ``octaves``: per octave (h, w, strip, fits, nbt, gbase): its size, the
    layouts' row strip, whether kernel F builds it (else the fallback), its
    twin blocks per row and its first row in the gauss buffer.  ``g_total``
    twin rows per image (a whole number of ``unit``-row units), of width
    2 * ``blk``, hold gauss layers [g_l0, g_l0 + g_nl); ``pk_total`` packed
    rows per image hold the DoGs, octave o from row ``pk_bases[o]`` with
    ``pk_nbps[o]`` blocks per image row.
    """

    octaves: tuple
    g_total: int
    unit: int
    blk: int
    g_l0: int
    g_nl: int
    pk_bases: tuple
    pk_nbps: tuple
    pk_total: int


def front_twin_pyramids(initial: torch.Tensor, cfg: SiftConfig, plan: FrontTwinPlan):
    """initial (B, H, W) -> (gauss ``MultiRows``, DoG ``CubeRows``, masks,
    counts): the front-twin route's pyramids.  Per octave kernel F
    (ops/octave_front.octave_front_twin) writes the octave's regions of both
    buffers in place.  An octave the plan marks as not fitting goes through
    kernel A instead, its gauss stack through ``twin_strided`` and its DoG
    stack through kernel G (ops/cube_pack.cube_pack_rows) into the same
    regions.  The buffers start as zeros, which is what lanes past the
    image, rows past H and the gaps between octaves keep."""
    hks = blur_half_kernels(cfg)
    thr = cfg.extremum_threshold()
    n = len(hks)
    bsz = initial.shape[0]
    u, blk = plan.unit, plan.blk
    gbuf = torch.zeros((bsz, plan.g_total // u, u * 2 * blk), dtype=initial.dtype,
                       device=initial.device)
    grows = gbuf.view(bsz, plan.g_total, 2 * blk)  # the same bytes, row by row
    pkbuf = torch.zeros((bsz, plan.pk_total, 128), dtype=initial.dtype, device=initial.device)
    masks, counts = [], []
    img = initial.contiguous()
    for (h, w, st, fits, nbt, gbase), pkbase in zip(plan.octaves, plan.pk_bases):
        if fits:
            m, c, down = octave_front_twin(img, hks, thr, grows, gbase, st, blk, plan.g_l0,
                                           plan.g_nl, pkbuf, pkbase, cfg.window_size)
        else:
            g, d, m, c = octave_front(img, hks, thr, cfg.window_size)
            gt = twin_strided(g, blk, st, plan.g_l0, plan.g_nl)
            grows[:, gbase: gbase + gt.shape[1]] = gt
            cube_pack_rows(d, st, out=pkbuf, base=pkbase)
            down = g[:, g.shape[1] - 3]
        masks.append(m)
        counts.append(c)
        img = downsample_nearest_x2(down).contiguous()
    shp = tuple(o[2].bit_length() - 1 for o in plan.octaves)
    stride, sw, _ = cube_rows_params(n, plan.octaves[0][1])
    gmr = MultiRows(
        rows=grows, shapes=tuple((n + 1, o[0], o[1]) for o in plan.octaves), blk=blk,
        nbs=tuple(o[4] for o in plan.octaves),
        # shifted by -l0 * nb * st: the row formula takes the stack's layer index
        bases=tuple(o[5] - plan.g_l0 * o[4] * o[2] for o in plan.octaves),
        shp=shp, nls=(plan.g_nl,) * len(plan.octaves), l0=plan.g_l0, unit=u,
    )
    dcr = CubeRows(
        rows=pkbuf, shapes=tuple((n, o[0], o[1]) for o in plan.octaves),
        nbps=plan.pk_nbps, bases=plan.pk_bases, stride=stride, sw=sw, lss=shp,
    )
    return gmr, dcr, masks, counts
