"""End-to-end SIFT: batched detect + describe (src/sift.cpp:712-776).

Counterpart of ``sift_tpu/models/sift.py``.  ``detect_and_describe_batch``
takes one of three routes (``route_of``), chosen as the JAX package chooses;
``run_route`` runs any of the four by name:

* ``"front_twin"`` (float32, window 3, on the card by default;
  ``use_front``), the route of the JAX entry point:
  1. ``front_twin``: initial image, then per octave kernel F (blur chain,
     DoG, extremum mask, popcounts) writes the gauss twin rows and the
     cube-packed DoG rows into two shared gather buffers, and the next
     octave's seed; no plain stack exists;
  2. ``detect_refine``: counts-assisted extrema compaction + cascaded
     Newton refinement over the ``CubeRows``, compacted to ``kp_cap`` (on
     the card in one launch of kernel J);
* ``"front"``: the same with kernel A and plain stacks (``front``, then
  ``detect_refine`` over their ``StackSpace``), the JAX package's
  ``_jit_front_batch``; reached only through ``run_route``;
* the non-front route (float64, another window, or the CPU by default):
  1. ``pyramids``: initial image, then ``build_pyramids`` (kernel C per
     octave, or the blur chain through kernel D);
  2. ``_detect_refine_fused``: extrema of all octaves from the DoG stacks +
     the same cascaded refinement;
  in float32 on the card (``"twin_rows"``, ``use_twin_rows``) it gathers
  from the twin rows that kernel E writes, as the JAX package's does from
  ``twin_rows_strips``; else (``"stacks"``) from the plain stacks;

and then on every route, over the route's gauss gather space:
  3. ``orient``: orientation candidates, compacted to ``ori_cap``;
  4. ``dedup``: the reference's sort + unique, compacted;
  5. ``describe``: descriptors.

Each stage is a plain function on tensors, so a caller can time them one
by one.  ``detect_fn`` is the JAX package's one-image function of the same
name (the non-front route with row-major gathers), which its ``parallel/``
maps over a batch.  ``detect_stages`` is the staged path: one image, octave by octave,
every stage's output kept (the parity and debugging view); its stages
gather from row-major twin rows (``gather.build_block_rows`` /
``build_multi_rows``, kernel H in float32 on the card).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sift_tpu_torch.config import SiftConfig, kernel_on
from sift_tpu_torch.models.descriptor import (
    compute_descriptors_all,
    compute_octave_descriptors,
)
from sift_tpu_torch.models.detect import (
    detect_extrema_all,
    detect_octave_extrema,
    extrema_from_counts,
    refine_keypoints_all,
    refine_octave_keypoints,
)
from sift_tpu_torch.models.orient import orient_all, orient_octave_keypoints
from sift_tpu_torch.models.pyramid import (
    FrontTwinPlan,
    blur_half_kernels,
    build_pyramids,
    compute_initial_image,
    front_pyramids,
    front_twin_pyramids,
)
from sift_tpu_torch.ops.detect import applies as detect_kernel_applies
from sift_tpu_torch.ops.detect import detect_kernel
from sift_tpu_torch.ops.gather import (
    StackSpace,
    build_multi_rows,
    compact_mask,
    cube_rows_params,
)
from sift_tpu_torch.ops.octave_front import front_twin_strip
from sift_tpu_torch.ops.twin_rows import twin_rows_strips
from sift_tpu_torch.utils import keypoints as kputil
from sift_tpu_torch.utils import native, profiling
from sift_tpu_torch.utils.keypoints import Keypoints
from sift_tpu_torch.utils.numerics import resolve_device


def as_batch(images, cfg: SiftConfig, device) -> torch.Tensor:
    """(B, H, W[, C]) array or tensor -> (B, H, W, C) ``cfg.dtype`` tensor
    on ``device``.

    The pixels cross to the device in their own dtype and are converted
    there: a host-to-card copy that also changes the dtype converts on the
    host first, so a uint8 batch would cross as float32, four times the
    bytes.  Only a wider input (float64 for the float32 profile) is
    narrowed before it crosses.  A tensor already on the device is not
    copied.  Either side converts with the same rounding, so the result
    does not depend on where.
    """
    imgs = images if torch.is_tensor(images) else torch.as_tensor(np.asarray(images))
    if imgs.dtype.itemsize > cfg.dtype.itemsize:
        imgs = imgs.to(cfg.dtype)
    dev = resolve_device(device)
    if imgs.device.type != dev.type:  # a copy from host memory waits for the card
        with profiling.span("sift.sync.upload"):
            imgs = imgs.to(dev)
    imgs = imgs.to(dev).to(cfg.dtype)
    if imgs.dim() == 3:  # grayscale batch: make the channel explicit
        imgs = imgs[..., None]
    return imgs


def octaves_for(imgs: torch.Tensor, cfg: SiftConfig) -> int:
    scale = 2 if cfg.double_image_size else 1
    return cfg.octaves_count(imgs.shape[2] * scale, imgs.shape[1] * scale)


def use_front(cfg: SiftConfig, device) -> bool:
    """The batch route (the JAX package's ``_use_front``, with CUDA in the
    TPU's place): the front-twin route needs window 3 and float32, and runs
    when ``use_octave_kernel`` is True, or None on the card."""
    return cfg.window_size == 3 and kernel_on(cfg.use_octave_kernel, cfg.dtype, device)


def use_twin_rows(cfg: SiftConfig, device) -> bool:
    """The non-front route's gather layout (the JAX package's
    ``_use_pallas_relayout``, with CUDA in the TPU's place): kernel E's
    twin rows for float32 on the card, else the plain stacks."""
    return cfg.dtype == torch.float32 and torch.device(device).type == "cuda"


def route_of(cfg: SiftConfig, device) -> str:
    """``"front_twin"``, ``"twin_rows"`` or ``"stacks"`` (see the module
    doc)."""
    if use_front(cfg, device):
        return "front_twin"
    return "twin_rows" if use_twin_rows(cfg, device) else "stacks"


# Twin block width of the batch routes' gather spaces: the JAX package's
# _REFINE_BLK for the DoGs and its gauss rows' width.
TWIN_BLK = 64


def gather_space(stacks, twin_rows: bool):
    """One gather space over per-octave (B, S, H_o, W_o) stacks: kernel
    E's ``MultiRows`` or the plain ``StackSpace``."""
    return twin_rows_strips(stacks, TWIN_BLK) if twin_rows else StackSpace.build(stacks)


def front(imgs: torch.Tensor, cfg: SiftConfig, octaves: int | None = None):
    """Front route, stage 1: (gaussians, dogs, masks, counts), per-octave
    lists.  ``octaves``: the pyramid's depth (default ``octaves_for``)."""
    with profiling.span("sift.front"):
        initial = compute_initial_image(imgs, cfg)
        return front_pyramids(initial, cfg, octaves or octaves_for(imgs, cfg))


def front_twin_plan(cfg: SiftConfig, octaves: int, h1: int, w1: int,
                    strip_fn=front_twin_strip) -> FrontTwinPlan:
    """The front-twin route's buffer layout for (h1, w1) initial images
    (the JAX package's ``_front_twin_plan`` and the packed-row bases of its
    ``_jit_front_twin_batch``, number for number).  ``strip_fn(shape,
    half_kernels, g_nl, blk, dtype)`` gives each octave's row strip, or None
    for an octave that takes the fallback."""
    hks = blur_half_kernels(cfg)
    n = len(hks)
    g_l0, g_nl = 1, n - 2  # stored gauss layers [1, intervals]
    plan, gacc, pk_bases, pk_nbps, pkacc = [], 0, [], [], 0
    h, w = h1, w1
    for _ in range(octaves):
        nbt = -(-w // TWIN_BLK)
        st = strip_fn((h, w), hks, g_nl, TWIN_BLK, cfg.dtype)
        fits = st is not None
        if st is None:  # fallback octave: any power-of-two strip works
            st = min(128, max(32, 1 << max(h - 1, 7).bit_length()))
        nstrips = -(-h // st)
        g_unit = g_nl * nbt * st
        gacc = -(-gacc // g_unit) * g_unit
        plan.append((h, w, st, fits, nbt, gacc))
        gacc += nstrips * g_unit
        nbp = cube_rows_params(n, w)[2]
        pkacc = -(-pkacc // (nbp * st)) * (nbp * st)
        pk_bases.append(pkacc)
        pk_nbps.append(nbp)
        pkacc += nstrips * nbp * st
        h, w = h // 2, w // 2
    u = min(8, *(p[2] for p in plan))
    return FrontTwinPlan(
        octaves=tuple(plan), g_total=-(-gacc // (8 * u)) * (8 * u), unit=u, blk=TWIN_BLK,
        g_l0=g_l0, g_nl=g_nl, pk_bases=tuple(pk_bases), pk_nbps=tuple(pk_nbps), pk_total=pkacc,
    )


def front_twin(imgs: torch.Tensor, cfg: SiftConfig, plan: FrontTwinPlan | None = None,
               octaves: int | None = None):
    """Front-twin route, stage 1: (gauss ``MultiRows``, DoG ``CubeRows``,
    masks, counts).  ``plan``: a layout other than ``front_twin_plan``'s
    (callers that stage the route by hand, to send octaves through the
    fallback); ``octaves``: as for ``front``."""
    with profiling.span("sift.front_twin"):
        initial = compute_initial_image(imgs, cfg)
        if plan is None:
            plan = front_twin_plan(cfg, octaves or octaves_for(imgs, cfg), *initial.shape[1:])
        return front_twin_pyramids(initial, cfg, plan)


def pyramids(imgs: torch.Tensor, cfg: SiftConfig, octaves: int | None = None):
    """Non-front route, stage 1: (gaussians, dogs), per-octave lists;
    ``octaves``: as for ``front``."""
    with profiling.span("sift.pyramids"):
        initial = compute_initial_image(imgs, cfg)
        return build_pyramids(initial, cfg, octaves or octaves_for(imgs, cfg))


def detect_refine(dog_space, masks, counts, cfg: SiftConfig):
    """Front and front-twin routes, stage 2: (keypoints (B, kp_cap), counts
    dict), refined over a gather space of the DoGs (the front-twin route's
    ``CubeRows``, the front route's ``StackSpace``).  Float32 on the card
    takes kernel J (``ops/detect.detect_kernel``: one launch, no host read);
    the CPU and float64 take the plain chain."""
    with profiling.span("sift.detect_refine"):
        if detect_kernel_applies(dog_space, cfg):
            return detect_kernel(dog_space, masks, counts, cfg)
        return _refine(dog_space, *extrema_from_counts(masks, counts, cfg.extrema_cap), cfg)


def _detect_refine_fused(dogs, cfg: SiftConfig, twin_rows: bool):
    """Non-front route, stage 2: same contract as ``detect_refine``;
    ``twin_rows``: refine from kernel E's twin rows of the DoGs."""
    with profiling.span("sift.detect_refine"):
        return _refine(gather_space(dogs, twin_rows), *detect_extrema_all(
            dogs, cfg.extremum_threshold(), cfg.extrema_cap, cfg.window_size), cfg)


def _refine(space, oct_id, zyx, valid, n_ext, cfg: SiftConfig):
    kp, off0, n_active = refine_keypoints_all(space, oct_id, zyx, valid, cfg)
    n_ref = kp.valid.sum(-1, dtype=torch.int32)
    kp, off0 = kputil.compact(kp, cfg.kp_cap, extra=off0)
    if cfg.dtype == torch.float64:
        kp = host_exact_sizes(kp, off0, cfg)
    return kp, dict(extrema=n_ext, refined=n_ref, refine_active=n_active)


def orient(gsp, kp: Keypoints, cfg: SiftConfig):
    """Stage 3: (candidates (B, ori_cap), counts dict)."""
    with profiling.span("sift.orient"):
        cand, max_peaks = orient_all(gsp, kp, cfg)
        n_cand = cand.valid.sum(-1, dtype=torch.int32)
        return kputil.compact(cand, cfg.ori_cap), dict(
            oriented=n_cand, ori_slots_max=max_peaks
        )


def dedup(cand: Keypoints, cfg: SiftConfig) -> Keypoints:
    """Stage 4: clean_keypoints (sort + unique), compacted to ori_cap."""
    with profiling.span("sift.dedup"):
        return kputil.dedup_compact(cand, cfg.ori_cap)


def describe(gsp, allkp: Keypoints, cfg: SiftConfig) -> Keypoints:
    """Stage 5: the final buffer with descriptors."""
    with profiling.span("sift.describe"):
        return dataclasses.replace(allkp, desc=compute_descriptors_all(gsp, allkp, cfg))


def detect_and_describe_batch(images, cfg: SiftConfig | None = None,
                              return_counts: bool = False, device="cuda"):
    """Batched detect + describe: (B, H, W[, C]) -> Keypoints with leading B.

    ``return_counts``: also return the true per-stage counts (extrema,
    refined, oriented: (B,); refine_active: (B, phases); ori_slots_max: the
    most orientation peaks of any keypoint).  A count above its capacity
    (extrema_cap, kp_cap, ori_cap, the Newton phase caps, ori_cand_slots)
    means real detections were clipped.
    """
    cfg = cfg or SiftConfig()
    with profiling.span("sift.entry"):
        imgs = as_batch(images, cfg, device)
        out, counts = run_route(imgs, cfg, route_of(cfg, imgs.device))
    return (out, counts) if return_counts else out


def run_route(imgs: torch.Tensor, cfg: SiftConfig, route: str,
              plan: FrontTwinPlan | None = None, octaves: int | None = None):
    """The stages of one batch route (``"front_twin"``, ``"front"``,
    ``"twin_rows"`` or ``"stacks"``) on a (B, H, W, C) tensor, whatever
    ``route_of`` would choose: (final buffer, counts dict).  ``plan``: see
    ``front_twin``; ``octaves``: the pyramid's depth (default
    ``octaves_for``)."""
    if route == "front_twin":
        gsp, dsp, masks, counts = front_twin(imgs, cfg, plan, octaves)
        kp, c_det = detect_refine(dsp, masks, counts, cfg)
        del dsp, masks, counts
    elif route == "front":
        gaussians, dogs, masks, counts = front(imgs, cfg, octaves)
        kp, c_det = detect_refine(StackSpace.build(dogs), masks, counts, cfg)
        del dogs, masks, counts
        gsp = StackSpace.build(gaussians)
        del gaussians
    elif route in ("twin_rows", "stacks"):
        gaussians, dogs = pyramids(imgs, cfg, octaves)
        kp, c_det = _detect_refine_fused(dogs, cfg, route == "twin_rows")
        del dogs
        gsp = gather_space(gaussians, route == "twin_rows")
        del gaussians
    else:
        raise ValueError(f"unknown route {route!r}")
    cand, c_ori = orient(gsp, kp, cfg)
    return describe(gsp, dedup(cand, cfg), cfg), {**c_det, **c_ori}


def detect_and_describe(image, cfg: SiftConfig | None = None, device="cuda") -> Keypoints:
    """One image, (H, W) or (H, W, C) in [0, 255]: a fixed-capacity buffer
    with a validity mask; ``.dense()`` gives the valid keypoints."""
    cfg = cfg or SiftConfig()
    img = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image) else image)
    return detect_and_describe_batch(img[None], cfg, device=device).map(lambda a: a[0])


def detect_fn(img, cfg: SiftConfig, octaves: int, device="cuda", return_counts: bool = False):
    """Detect + describe one (H, W[, C]) image through ``octaves`` octaves,
    as the JAX package's ``detect_fn`` (the function its ``parallel/``
    maps over a batch): the non-front route with the blur chain (kernel D
    for each float32 blur on the card, as the JAX function forces its XLA
    blur), extrema and Newton refinement of all octaves at ``cfg.kp_cap``,
    orientation and descriptors gathered from row-major ``MultiRows``
    (``build_multi_rows``, kernel H in float32 on the card), dedup.
    Returns one (ori_cap,) buffer; with ``return_counts`` also the true
    per-stage counts, as ``detect_and_describe_batch`` gives them for a
    batch of one."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img)
    initial = compute_initial_image(as_batch(img[None], cfg, dev), cfg)
    gaussians, dogs = build_pyramids(
        initial, dataclasses.replace(cfg, use_octave_kernel=False), octaves)
    kp, c_det = _detect_refine_fused(dogs, cfg, False)
    del dogs
    gsp = build_multi_rows([g[0] for g in gaussians])
    del gaussians
    cand, c_ori = orient(gsp, kp, cfg)
    out = describe(gsp, dedup(cand, cfg), cfg).map(lambda a: a[0])
    return (out, {**c_det, **c_ori}) if return_counts else out


def host_exact_sizes(kp: Keypoints, off0, cfg: SiftConfig) -> Keypoints:
    """Recompute kp.size with the host's libm pow for the float64 parity
    profile (src/sift.cpp:427-429): size = init_sigma * 2^octave *
    pow(2, (layer + offset) / intervals), per valid lane."""
    size = kp.size.cpu().numpy().copy()
    layer = kp.layer.cpu().numpy().astype(np.float64)
    off = off0.cpu().numpy().astype(np.float64)
    scale = cfg.init_sigma * np.power(2.0, kp.octave.cpu().numpy().astype(np.float64))
    t = (layer + off) / float(cfg.intervals)
    valid = kp.valid.cpu().numpy()
    p = native.pow2_glibc(t)  # libm's pow(2, .) per lane, bit-equal to math.pow
    if p is not None:
        np.copyto(size, scale * p, where=valid)
    else:
        flat_s, flat_t, flat_sc = size.reshape(-1), t.reshape(-1), scale.reshape(-1)
        for i in np.nonzero(valid.reshape(-1))[0]:
            flat_s[i] = flat_sc[i] * math.pow(2, float(flat_t[i]))
    return dataclasses.replace(kp, size=torch.from_numpy(size).to(kp.size.device))


def detect_stages(img, cfg: SiftConfig, octaves: int, device="cuda") -> dict:
    """The staged path: every stage of one image, octave by octave (the JAX
    package's ``detect_stages``, after the stage boundaries of
    src/sift.cpp:712-776).

    ``img``: (H, W[, C]).  Returns initial (H1, W1), gaussians / dogs (per
    octave (S, H_o, W_o)), extrema (per octave (zyx, valid)), refined and
    oriented (per octave lane buffers), final (the deduplicated buffer with
    descriptors) and counts.  Capacities are per octave, octave 0's halved
    per octave: ``extrema_cap_for_octave`` extrema, ``kp_cap_for_octave``
    refined keypoints and twice that many orientation candidates; the
    deduplicated buffer holds ``ori_cap``.  ``counts`` holds the true
    per-octave counts (extrema, refined, oriented, ori_slots_max: (octaves,))
    and the deduplicated total (final), for the capacity check.  In float64
    the refined sizes take the host's pow (``host_exact_sizes``: every valid
    lane of one octave's buffer has that octave).
    """
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img)
    initial = compute_initial_image(as_batch(img[None], cfg, dev), cfg)
    gaussians, dogs = build_pyramids(initial, cfg, octaves)
    gaussians = [g[0] for g in gaussians]
    dogs = [d[0] for d in dogs]
    out = dict(initial=initial[0], gaussians=gaussians, dogs=dogs,
               extrema=[], refined=[], oriented=[])
    counts = dict(extrema=[], refined=[], oriented=[], ori_slots_max=[])
    for o in range(octaves):
        zyx, valid, n_ext = detect_octave_extrema(
            dogs[o], cfg.extremum_threshold(), cfg.extrema_cap_for_octave(o),
            cfg.window_size,
        )
        out["extrema"].append((zyx, valid))
        kp, off0 = refine_octave_keypoints(dogs[o], zyx, valid, o, cfg)
        n_ref = kp.valid.sum(dtype=torch.int32)
        kp, off0 = kputil.compact(kp, cfg.kp_cap_for_octave(o), extra=off0)
        if cfg.dtype == torch.float64:
            kp = host_exact_sizes(kp, off0, cfg)
        out["refined"].append(kp)
        cand, max_peaks = orient_octave_keypoints(gaussians[o], kp, o, cfg)
        n_ori = cand.valid.sum(dtype=torch.int32)
        out["oriented"].append(kputil.compact(cand, 2 * cfg.kp_cap_for_octave(o)))
        for k, v in zip(counts, (n_ext, n_ref, n_ori, max_peaks)):
            counts[k].append(v)
    ded = kputil.sort_and_dedup(kputil.concatenate(out["oriented"]))
    allkp = kputil.compact(ded, cfg.ori_cap)
    desc = allkp.desc
    for o in range(octaves):
        desc = _octave_descriptors(gaussians[o], allkp, desc, o, cfg)
    out["final"] = dataclasses.replace(allkp, desc=desc)
    out["counts"] = {k: torch.stack(v) for k, v in counts.items()}
    out["counts"]["final"] = ded.valid.sum(dtype=torch.int32)
    return out


def _octave_descriptors(gauss, allkp: Keypoints, desc, octave: int, cfg: SiftConfig):
    """``desc`` with the descriptors of ``allkp``'s octave-``octave`` lanes
    filled in: the first 2 * kp_cap_for_octave of them, as the JAX
    package's staged path selects them (compact_mask)."""
    sel = allkp.valid & (allkp.octave == octave)
    idx, in_range = compact_mask(sel, 2 * cfg.kp_cap_for_octave(octave))
    sub = kputil.take(allkp, idx)
    sub = dataclasses.replace(sub, valid=sub.valid & in_range)
    got = compute_octave_descriptors(gauss, sub, octave, cfg)
    desc = desc.clone()
    desc[idx[in_range]] = got[in_range]
    return desc
