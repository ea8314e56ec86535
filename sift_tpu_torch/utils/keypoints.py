"""Fixed-capacity keypoint lane buffers (struct of tensors).

The reference's ``std::vector<Keypoint>`` (src/sift.hh:15-53) becomes
parallel tensors with a validity mask.  Every field has the lane axis last,
so a batch of images is a leading dimension: ``x`` is (N,) or (B, N) and
``desc`` is (N, 128) or (B, N, 128).  Counterpart of
``sift_tpu.utils.keypoints``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sift_tpu_torch.ops.gather import compact_mask

FIELDS = ("x", "y", "octave", "layer", "size", "pori", "desc", "valid")


@dataclasses.dataclass
class Keypoints:
    """x, y: image coordinates; octave, layer: int32; size; pori in
    [0, 2*pi); desc: uint8[128]; valid: lane mask."""

    x: torch.Tensor
    y: torch.Tensor
    octave: torch.Tensor
    layer: torch.Tensor
    size: torch.Tensor
    pori: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    def map(self, fn) -> "Keypoints":
        return Keypoints(**{f: fn(getattr(self, f)) for f in FIELDS})

    @staticmethod
    def from_numpy(arrays, device="cpu") -> "Keypoints":
        """Lane buffers (a mapping or an object with the eight fields, e.g.
        the JAX package's Keypoints) -> tensors on ``device``."""
        get = arrays.__getitem__ if isinstance(arrays, dict) else (
            lambda f: getattr(arrays, f)
        )
        out = {}
        for f in FIELDS:
            a = np.asarray(get(f))
            if f in ("octave", "layer"):
                a = a.astype(np.int32)
            elif f == "desc":
                a = a.astype(np.uint8)
            elif f == "valid":
                a = a.astype(bool)
            out[f] = torch.tensor(a, device=device)
        return Keypoints(**out)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """All lanes, valid or not, as numpy arrays (inverse of from_numpy)."""
        return {f: getattr(self, f).detach().cpu().numpy() for f in FIELDS}

    def dense(self) -> dict[str, np.ndarray]:
        """Host view of the valid lanes only (one image)."""
        lanes = self.to_numpy()
        v = lanes.pop("valid")
        return {f: a[v] for f, a in lanes.items()}


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., idx] along the lane axis (the axis before 128 for desc)."""
    if a.dim() == idx.dim() + 1:
        return torch.gather(a, -2, idx.unsqueeze(-1).expand(*idx.shape, a.shape[-1]))
    return torch.gather(a, -1, idx)


def take(kp: Keypoints, idx: torch.Tensor) -> Keypoints:
    """The lanes ``idx`` of every field, in that order."""
    return Keypoints(**{f: _take(getattr(kp, f), idx) for f in FIELDS})


def concatenate(kps: list[Keypoints]) -> Keypoints:
    """Lane buffers joined along the lane axis."""
    return Keypoints(**{
        f: torch.cat([getattr(k, f) for k in kps], dim=-2 if f == "desc" else -1)
        for f in FIELDS
    })


def _fit(a: torch.Tensor, out_cap: int, lane_dim: int) -> torch.Tensor:
    """Cut or zero-pad the lane axis to ``out_cap``."""
    n = a.shape[lane_dim]
    if out_cap <= n:
        return a.narrow(lane_dim, 0, out_cap)
    shape = list(a.shape)
    shape[lane_dim] = out_cap - n
    return torch.cat([a, a.new_zeros(shape)], dim=lane_dim)


def compact_indices(valid: torch.Tensor, out_cap: int):
    """Indices packing valid lanes front-first: ``(idx, in_range)``, as
    ``ops/gather.compact_mask`` gives them (idx clamped into [0, n - 1])."""
    return compact_mask(valid, out_cap)


def compact(kp: Keypoints, out_cap: int, extra=None):
    """Pack valid lanes to the front of an ``out_cap``-lane buffer.

    ``extra``: optional tensor (lanes last) compacted alongside.  Valid
    lanes keep their order, as in the JAX package's stable-sort compaction.
    """
    idx, sel = compact_mask(kp.valid, min(out_cap, kp.x.shape[-1]))

    def one(a, lane_dim=-1):
        return _fit(_take(a, idx), out_cap, lane_dim)

    out = Keypoints(
        x=one(kp.x), y=one(kp.y), octave=one(kp.octave), layer=one(kp.layer),
        size=one(kp.size), pori=one(kp.pori), desc=one(kp.desc, -2),
        valid=_fit(sel, out_cap, -1),
    )
    if extra is None:
        return out
    return out, one(extra)


def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic order, ``keys[0]`` most significant."""
    order = torch.arange(keys[0].shape[-1], device=keys[0].device)
    order = order.expand_as(keys[0])
    for k in reversed(keys):
        o = torch.sort(torch.gather(k, -1, order), dim=-1, stable=True).indices
        order = torch.gather(order, -1, o)
    return order


def sort_and_dedup(kp: Keypoints) -> Keypoints:
    """clean_keypoints (src/sift.cpp:20-24): sort + unique.

    Sort key (src/sift.hh:31-41): x asc, y asc, size DESC, pori asc, octave
    DESC; equality for dedup ignores octave/layer (src/sift.hh:25-27).
    Invalid lanes sort to the end.
    """
    v = kp.valid
    keys = [
        torch.where(v, kp.x, math.inf),
        torch.where(v, kp.y, math.inf),
        torch.where(v, -kp.size, math.inf),
        torch.where(v, kp.pori, math.inf),
        torch.where(v, -kp.octave, torch.full_like(kp.octave, 2**30)),
    ]
    kp = take(kp, _lexsort(keys))
    same = torch.ones_like(kp.valid)
    for k in (kp.x, kp.y, kp.size, kp.pori):
        same &= k == torch.roll(k, 1, dims=-1)
    same[..., 0] = False
    return dataclasses.replace(kp, valid=kp.valid & ~same)


def dedup_compact(kp: Keypoints, out_cap: int) -> Keypoints:
    """``compact(sort_and_dedup(kp), out_cap)`` with zeroed invalid lanes and
    fresh zero descriptors (the JAX package's fused dedup + compaction)."""
    out = compact(sort_and_dedup(kp), out_cap)
    keep = out.valid

    def clean(a):
        return torch.where(keep, a, torch.zeros_like(a))

    return Keypoints(
        x=clean(out.x), y=clean(out.y), octave=clean(out.octave),
        layer=clean(out.layer), size=clean(out.size), pori=clean(out.pori),
        desc=torch.zeros_like(out.desc), valid=keep,
    )
