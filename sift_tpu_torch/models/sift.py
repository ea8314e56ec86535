"""End-to-end SIFT: batched detect + describe (src/sift.cpp:712-776).

The JAX package's fused route, stage by stage on plain per-octave stacks:

  1. ``front``: initial image, then per octave kernel A (blur chain, DoG,
     extremum mask, popcounts) and the next octave's seed;
  2. ``detect_refine``: counts-assisted extrema compaction + cascaded
     Newton refinement, compacted to ``kp_cap``;
  3. ``orient``: orientation candidates, compacted to ``ori_cap``;
  4. ``dedup``: the reference's sort + unique, compacted;
  5. ``describe``: descriptors.

Each stage is a plain function on tensors, so a caller can time them one
by one; ``detect_and_describe_batch`` runs them in order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.models.descriptor import compute_descriptors_all
from sift_tpu_torch.models.detect import extrema_from_counts, refine_keypoints_all
from sift_tpu_torch.models.orient import orient_all
from sift_tpu_torch.models.pyramid import build_pyramids, compute_initial_image
from sift_tpu_torch.ops.gather import StackSpace
from sift_tpu_torch.utils import keypoints as kputil
from sift_tpu_torch.utils.keypoints import Keypoints
from sift_tpu_torch.utils.numerics import resolve_device


def as_batch(images, cfg: SiftConfig, device) -> torch.Tensor:
    """(B, H, W[, C]) array or tensor -> (B, H, W, C) tensor on ``device``."""
    imgs = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
    imgs = imgs.to(device=resolve_device(device), dtype=cfg.dtype)
    if imgs.dim() == 3:  # grayscale batch: make the channel explicit
        imgs = imgs[..., None]
    return imgs


def octaves_for(imgs: torch.Tensor, cfg: SiftConfig) -> int:
    scale = 2 if cfg.double_image_size else 1
    return cfg.octaves_count(imgs.shape[2] * scale, imgs.shape[1] * scale)


def front(imgs: torch.Tensor, cfg: SiftConfig):
    """Stage 1: (gaussians, dogs, masks, counts), per-octave lists."""
    initial = compute_initial_image(imgs, cfg)
    return build_pyramids(initial, cfg, octaves_for(imgs, cfg))


def detect_refine(dogs, masks, counts, cfg: SiftConfig):
    """Stage 2: (keypoints (B, kp_cap), counts dict)."""
    oct_id, zyx, valid, n_ext = extrema_from_counts(masks, counts, cfg.extrema_cap)
    kp, off0, n_active = refine_keypoints_all(
        StackSpace.build(dogs), oct_id, zyx, valid, cfg
    )
    n_ref = kp.valid.sum(-1, dtype=torch.int32)
    kp, off0 = kputil.compact(kp, cfg.kp_cap, extra=off0)
    if cfg.dtype == torch.float64:
        kp = host_exact_sizes(kp, off0, cfg)
    return kp, dict(extrema=n_ext, refined=n_ref, refine_active=n_active)


def orient(gsp: StackSpace, kp: Keypoints, cfg: SiftConfig):
    """Stage 3: (candidates (B, ori_cap), counts dict)."""
    cand, max_peaks = orient_all(gsp, kp, cfg)
    n_cand = cand.valid.sum(-1, dtype=torch.int32)
    return kputil.compact(cand, cfg.ori_cap), dict(
        oriented=n_cand, ori_slots_max=max_peaks
    )


def dedup(cand: Keypoints, cfg: SiftConfig) -> Keypoints:
    """Stage 4: clean_keypoints (sort + unique), compacted to ori_cap."""
    return kputil.dedup_compact(cand, cfg.ori_cap)


def describe(gsp: StackSpace, allkp: Keypoints, cfg: SiftConfig) -> Keypoints:
    """Stage 5: the final buffer with descriptors."""
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
    imgs = as_batch(images, cfg, device)
    gaussians, dogs, masks, counts = front(imgs, cfg)
    kp, c_det = detect_refine(dogs, masks, counts, cfg)
    del dogs, masks, counts
    gsp = StackSpace.build(gaussians)
    del gaussians
    cand, c_ori = orient(gsp, kp, cfg)
    out = describe(gsp, dedup(cand, cfg), cfg)
    if return_counts:
        return out, {**c_det, **c_ori}
    return out


def detect_and_describe(image, cfg: SiftConfig | None = None, device="cuda") -> Keypoints:
    """One image, (H, W) or (H, W, C) in [0, 255]: a fixed-capacity buffer
    with a validity mask; ``.dense()`` gives the valid keypoints."""
    cfg = cfg or SiftConfig()
    img = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image) else image)
    return detect_and_describe_batch(img[None], cfg, device=device).map(lambda a: a[0])


def host_exact_sizes(kp: Keypoints, off0, cfg: SiftConfig) -> Keypoints:
    """Recompute kp.size with the host's libm pow for the float64 parity
    profile (src/sift.cpp:427-429): size = init_sigma * 2^octave *
    pow(2, (layer + offset) / intervals), per valid lane."""
    size = kp.size.cpu().numpy().copy()
    layer = kp.layer.cpu().numpy().astype(np.float64)
    off = off0.cpu().numpy().astype(np.float64)
    scale = cfg.init_sigma * np.power(2.0, kp.octave.cpu().numpy().astype(np.float64))
    t = (layer + off) / float(cfg.intervals)
    flat_s, flat_t, flat_sc = size.reshape(-1), t.reshape(-1), scale.reshape(-1)
    for i in np.nonzero(kp.valid.cpu().numpy().reshape(-1))[0]:
        flat_s[i] = flat_sc[i] * math.pow(2, float(flat_t[i]))
    return dataclasses.replace(kp, size=torch.from_numpy(size).to(kp.size.device))
