"""Mask compaction, tiny-table lookups and plain-stack gathers.

The JAX package gathers from TPU-shaped layouts (twin rows, row units,
cube-packed DoG rows) built for the TPU's DMA granularity.  The port reads
plain per-octave stacks instead: every octave's (B, S, H, W) stack is
flattened into one (B, total) buffer, and ``StackSpace`` records where each
octave starts.  Cubes and patches are then one element gather each.
"""

from __future__ import annotations

import dataclasses

import torch


def compact_mask(flat: torch.Tensor, cap: int):
    """Ascending indices of the first ``cap`` <= n True lanes of ``flat`` (lanes
    last, any leading batch dims): ``(idx, valid)`` with ``idx`` int64 in
    [0, n-1] and ``valid[k]`` iff there are more than ``k`` set lanes."""
    n = flat.shape[-1]
    idx = torch.sort((~flat).to(torch.uint8), dim=-1, stable=True).indices[..., :cap]
    total = flat.sum(-1, keepdim=True)
    valid = torch.arange(cap, device=flat.device) < total
    return torch.where(valid, idx, torch.full_like(idx, n - 1)), valid


def lut(values, sel: torch.Tensor, dtype) -> torch.Tensor:
    """Per-lane lookup of a tiny static table: out[i] = values[sel[i]]."""
    table = torch.tensor(values, dtype=dtype, device=sel.device)
    return table[sel.long()]


@dataclasses.dataclass
class StackSpace:
    """Per-octave (B, S, H_o, W_o) stacks flattened into one buffer.

    ``flat`` is (B * total,): image ``b``'s octave ``o`` starts at
    ``b * total + bases[o]``, its element (s, y, x) sits at
    ``(s * H_o + y) * W_o + x`` from there.
    """

    flat: torch.Tensor
    shapes: tuple  # (S, H, W) per octave
    bases: tuple
    total: int

    @staticmethod
    def build(stacks: list[torch.Tensor]) -> "StackSpace":
        b = stacks[0].shape[0]
        parts = [s.reshape(b, -1) for s in stacks]
        bases, acc = [], 0
        for p in parts:
            bases.append(acc)
            acc += p.shape[1]
        return StackSpace(
            flat=torch.cat(parts, dim=1).reshape(-1),
            shapes=tuple(tuple(s.shape[1:]) for s in stacks),
            bases=tuple(bases),
            total=acc,
        )

    def origin(self, img: torch.Tensor, oct_id: torch.Tensor) -> torch.Tensor:
        """Flat offset of each lane's (image, octave) volume (int64)."""
        return img.long() * self.total + lut(self.bases, oct_id, torch.int64)

    def table(self, axis: int, oct_id: torch.Tensor) -> torch.Tensor:
        """Per-lane octave dimension (0: S, 1: H, 2: W), int64."""
        return lut([s[axis] for s in self.shapes], oct_id, torch.int64)


def gather_cubes(sp: StackSpace, img, oct_id, zyx) -> torch.Tensor:
    """(..., 3, 3, 3) cubes cube[a, b, c] = vol[z+a-1, y+b-1, x+c-1].

    Positions are clamped to the interior for the read only: valid lanes
    always are interior, and invalid lanes' values are never used.
    """
    h = sp.table(1, oct_id)
    w = sp.table(2, oct_id)
    s = sp.table(0, oct_id)
    z = torch.minimum(zyx[..., 0].long().clamp_min(1), s - 2)
    y = torch.minimum(zyx[..., 1].long().clamp_min(1), h - 2)
    x = torch.minimum(zyx[..., 2].long().clamp_min(1), w - 2)
    d = torch.arange(-1, 2, device=zyx.device)
    e = (..., None, None, None)
    idx = (
        sp.origin(img, oct_id)[e]
        + ((z[e] + d[:, None, None]) * h[e] + (y[e] + d[None, :, None])) * w[e]
        + (x[e] + d[None, None, :])
    )
    return sp.flat[idx]


def gather_patches(sp: StackSpace, img, oct_id, layer, ys0, xs0, patch: int):
    """(N, patch, patch) patches p[n, a, b] = vol[layer, ys0 + a, xs0 + b]
    with rows and columns clamped to the image (callers mask every sample
    whose gradient neighbourhood leaves the image, as the reference does)."""
    h = sp.table(1, oct_id)[:, None]
    w = sp.table(2, oct_id)[:, None]
    aa = torch.arange(patch, device=ys0.device)
    ys = torch.minimum((ys0.long()[:, None] + aa).clamp_min(0), h - 1)
    xs = torch.minimum((xs0.long()[:, None] + aa).clamp_min(0), w - 1)
    row = sp.origin(img, oct_id)[:, None] + (layer.long()[:, None] * h + ys) * w
    return sp.flat[row[:, :, None] + xs[:, None, :]]
