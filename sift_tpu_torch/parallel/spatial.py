"""Spatial (row-sharded) detection of ONE big image over the mesh.

Counterpart of ``sift_tpu/parallel/spatial.py`` (SURVEY.md section 2.7's
"spatial/tile parallel" slot): a single large frame is sharded by rows over
a mesh axis, each rank computing the pyramid, extrema, Newton refinement,
orientations and descriptors for its row band on a local HALO WINDOW, with
collectives carrying the inter-band dependencies:

  - every octave re-windows a replicated global seed (a local slice); the
    next octave's seed is reassembled from the disjoint owned bands with a
    masked ``all_reduce`` (SUM) over the axis, which is exact since each
    row has one owner and every other rank adds zeros;
  - the ranks' keypoint buffers are gathered over the axis and merged with
    one global dedup (the same sort as clean_keypoints, src/sift.cpp:20-24).

Exactness: the halo is sized so that every consumer of off-band rows stays
inside valid data -- the chained blurs consume ``sum_i radius_i`` rows of
the window margin (a window edge clamps only where it is the image's), and
the orientation / descriptor windows plus Newton walks reach at most
``desc_radius_bound + 1`` rows beyond an owned band.  Windows are clamped
inside the image (the first and last ranks place their band off-centre),
so border masks coincide with the single-device ones.  Octaves whose window
would exceed the octave height are computed whole on every rank, with the
same row-ownership masks.

Known deviations from the single-device pipeline, both beyond practical
reach, as in the JAX package: a Newton walker moving more than ``halo -
chain`` rows off its band reads decayed margin values, and the descriptor's
radius clamp to the image diagonal (src/sift.cpp:636-639) uses the window's.

Each octave's blur chain and DoGs come from ``models/pyramid.octave_stacks``
on the (1, win, W_o) window: kernel C in float32 on the card.  The initial
image is kernel D's, on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.models.descriptor import compute_octave_descriptors, desc_radius_bound
from sift_tpu_torch.models.detect import refine_octave_keypoints
from sift_tpu_torch.models.orient import orient_octave_keypoints
from sift_tpu_torch.models.pyramid import blur_half_kernels, compute_initial_image, octave_stacks
from sift_tpu_torch.models.sift import as_batch, host_exact_sizes
from sift_tpu_torch.ops.gather import compact_mask
from sift_tpu_torch.ops.octave_front import extremum_mask
from sift_tpu_torch.ops.resize import downsample_nearest_x2
from sift_tpu_torch.parallel.mesh import all_gather, all_reduce, axis_index, axis_size, mesh_device
from sift_tpu_torch.utils import keypoints as kputil
from sift_tpu_torch.utils.keypoints import Keypoints


def spatial_halo(cfg: SiftConfig) -> int:
    """Rows of window margin needed on each side of an owned band."""
    chain = sum(len(hk) - 1 for hk in blur_half_kernels(cfg))
    reach = desc_radius_bound(cfg) + 1  # widest consumer of gaussian rows
    return -(-(chain + reach + 4) // 8) * 8


def octave_dims(h2: int, w2: int, octaves: int) -> list[tuple[int, int]]:
    dims = []
    h, w = h2, w2
    for _ in range(octaves):
        dims.append((h, w))
        h, w = h // 2, w // 2
    return dims


def window_of(h_o: int, shard: int, d: int, halo: int) -> tuple[int, int, int, int]:
    """(own_lo, own_hi, wstart, win) of rank ``shard`` of ``d`` in an octave
    of ``h_o`` rows: its owned band and its halo window, clamped inside the
    octave."""
    band = -(-h_o // d)
    win = min(band + 2 * halo, h_o)
    own_lo = min(shard * band, h_o)
    own_hi = min(own_lo + band, h_o)
    wstart = min(max(own_lo - halo, 0), h_o - win)
    return own_lo, own_hi, wstart, win


def spatial_detect_and_describe(img, cfg: SiftConfig, mesh: DeviceMesh, axis: str = "data",
                                max_octaves: int | None = None) -> Keypoints:
    """Detect + describe ONE (H, W[, C]) image with rows sharded over
    ``axis``.

    Returns the global (ori_cap,) Keypoints buffer on every rank, equal to
    the staged single-device pipeline (``models/sift.detect_stages``) after
    dedup (see tests).  ``max_octaves`` caps the pyramid depth (compared
    against a staged run with the same cap).
    """
    dev = mesh_device(mesh)
    d, shard = axis_size(mesh, axis), axis_index(mesh, axis)
    img = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img)
    h_in, w_in = img.shape[0], img.shape[1]
    scale = 2 if cfg.double_image_size else 1
    octaves = cfg.octaves_count(w_in * scale, h_in * scale)
    if max_octaves is not None:
        octaves = min(octaves, max_octaves)
    halo = spatial_halo(cfg)
    hks = blur_half_kernels(cfg)
    n_layers = len(hks) + 1
    in_halve = 0.5 if cfg.double_image_size else 1.0
    b = cfg.window_size // 2

    seed = compute_initial_image(as_batch(img[None], cfg, dev), cfg)[0]  # replicated
    per_octave = []
    for o, (h_o, w_o) in enumerate(octave_dims(h_in * scale, w_in * scale, octaves)):
        own_lo, own_hi, wstart, win = window_of(h_o, shard, d, halo)
        g_loc, dog_loc = octave_stacks(seed[None, wstart: wstart + win].contiguous(), cfg, hks)
        g_loc, dog_loc = g_loc[0], dog_loc[0]

        # Extrema restricted to the owned band (each global extremum has
        # exactly one owner; detect_octave_extrema otherwise).
        mask = extremum_mask(dog_loc, cfg.extremum_threshold(), cfg.window_size)
        grow = torch.arange(mask.shape[1], device=dev) + (b + wstart)
        mask = mask & ((grow >= own_lo) & (grow < own_hi))[None, :, None]
        idx, valid = compact_mask(mask.reshape(-1), cfg.extrema_cap_for_octave(o))
        _, h2m, w2m = mask.shape
        zyx = torch.stack([idx // (h2m * w2m) + b, (idx // w2m) % h2m + b, idx % w2m + b],
                          dim=-1).to(torch.int32)

        kp, off0 = refine_octave_keypoints(dog_loc, zyx, valid, o, cfg)
        kp, off0 = kputil.compact(kp, cfg.kp_cap_for_octave(o), extra=off0)
        if cfg.dtype == torch.float64:
            kp = host_exact_sizes(kp, off0, cfg)
        cand, _ = orient_octave_keypoints(g_loc, kp, o, cfg)
        cand = kputil.compact(cand, 2 * cfg.kp_cap_for_octave(o))
        # Descriptors on LOCAL coordinates (consistent with g_loc), then y
        # shifted to global input coordinates.  Dedup runs globally after
        # the merge in clean_keypoints' order, so each duplicate's
        # representative (and its descriptor) is the single-device one.
        desc = compute_octave_descriptors(g_loc, cand, o, cfg)
        y_shift = wstart * (2.0 ** o * in_halve)
        cand = dataclasses.replace(cand, desc=desc,
                                   y=torch.where(cand.valid, cand.y + y_shift, cand.y))
        per_octave.append(cand)

        if o + 1 < octaves:
            # The next octave's replicated seed from the disjoint owned
            # bands: each rank's band on a zero canvas, summed over the axis.
            canvas = torch.zeros((h_o, w_o), dtype=seed.dtype, device=dev)
            canvas[own_lo:own_hi] = g_loc[n_layers - 3, own_lo - wstart: own_hi - wstart]
            seed = downsample_nearest_x2(all_reduce(canvas, mesh, axis)).contiguous()

    local = kputil.concatenate(per_octave)
    merged = local.map(lambda a: torch.cat(list(all_gather(a, mesh, axis)), dim=0))
    return kputil.compact(kputil.sort_and_dedup(merged), cfg.ori_cap)
