"""The comparison that decides ``correct``: the program's outputs against
the plain reference's (``benchmark/reference``), on the same inputs.

Keypoints are paired frame by frame: bit-equal keypoints (x, y, size,
orientation, octave, layer) pair first; what is left pairs when octave and
layer agree, x and y lie within ``XY_PX`` pixels, size within ``SIZE_REL``
of the reference's and the orientation within ``PORI_RAD`` radians, so a
sound float32 change that moves a keypoint by rounding keeps its partner.
The numbers compared:

* ``keypoints_unpaired_pct``: keypoints of either side left without a
  partner, per 100 reference keypoints;
* ``descriptor_bytes_off_pct``: descriptor bytes of paired keypoints that
  differ, per 100 bytes;
* ``matches_off_pct``: accepted matches (query keypoint, target keypoint,
  best squared distance) that only one side has, per 100 reference
  matches, the program's keypoints read through the pairing (a match whose
  keypoint has no partner counts as off);
* ``pixels_off``: pixels of the frames the program staged that differ from
  the frames handed to it (cells that read frames from files), an exact
  comparison.
"""

from __future__ import annotations

import numpy as np

XY_PX = 0.01
SIZE_REL = 1e-3
PORI_RAD = 0.01
FIELDS = ("x", "y", "size", "pori", "octave", "layer")


def pair_keypoints(prog: dict, ref: dict) -> np.ndarray:
    """For every program keypoint the index of its reference partner, or
    -1.  ``prog`` and ``ref``: dicts of numpy arrays of one frame's
    keypoints (``FIELDS``)."""
    n, m = len(prog["x"]), len(ref["x"])
    out = np.full(n, -1, np.int64)
    taken = np.zeros(m, bool)
    exact = {}
    for j in range(m):
        exact.setdefault(tuple(ref[f][j].item() for f in FIELDS), j)
    for i in range(n):
        j = exact.get(tuple(prog[f][i].item() for f in FIELDS))
        if j is not None and not taken[j]:
            out[i], taken[j] = j, True
    left = np.nonzero(out < 0)[0]
    free = np.nonzero(~taken)[0]
    if len(left) and len(free):
        p = {f: prog[f][left].astype(np.float64)[:, None] for f in FIELDS}
        r = {f: ref[f][free].astype(np.float64)[None, :] for f in FIELDS}
        dp = np.abs(p["pori"] - r["pori"]) % (2 * np.pi)
        ok = ((p["octave"] == r["octave"]) & (p["layer"] == r["layer"])
              & (np.abs(p["x"] - r["x"]) <= XY_PX) & (np.abs(p["y"] - r["y"]) <= XY_PX)
              & (np.abs(p["size"] - r["size"]) <= SIZE_REL * r["size"])
              & (np.minimum(dp, 2 * np.pi - dp) <= PORI_RAD))
        dist = np.where(ok, np.abs(p["x"] - r["x"]) + np.abs(p["y"] - r["y"]), np.inf)
        for a in np.argsort(dist.min(1), kind="stable"):
            b = int(np.argmin(dist[a]))
            if np.isfinite(dist[a, b]):
                out[left[a]] = free[b]
                dist[:, b] = np.inf
    return out


class Tally:
    """Running sums over the frames and pairs a run compares."""

    def __init__(self):
        self.ref_kp = self.unpaired = self.paired = self.bytes_off = 0
        self.ref_matches = self.matches_off = self.pairs = 0
        self.pixels_off = None

    def frame(self, prog: dict, ref: dict) -> np.ndarray:
        """Compare one frame's keypoints and descriptors; returns the
        pairing (``pair_keypoints``)."""
        pairing = pair_keypoints(prog, ref)
        ok = pairing >= 0
        self.ref_kp += len(ref["x"])
        self.unpaired += len(prog["x"]) + len(ref["x"]) - 2 * int(ok.sum())
        self.paired += int(ok.sum())
        self.bytes_off += int((prog["desc"][ok] != ref["desc"][pairing[ok]]).sum())
        return pairing

    def matches(self, prog, pairing1, pairing2, ref):
        """Compare one image pair's accepted matches.  ``prog`` and ``ref``:
        (best_idx, accept, best squared distance) per valid query keypoint
        in its order (``frame_dict``'s), best_idx naming a valid target
        keypoint (-1: none), the program's and the reference's over their
        own keypoints; ``pairing1`` / ``pairing2``: the pairings of the
        query and target frames."""
        ri, ra, rd = (np.asarray(a) for a in ref)
        pi, pa, pd = (np.asarray(a) for a in prog)
        ref = {(int(i), int(ri[i]), int(rd[i])) for i in np.nonzero(ra)[0]}
        prog = set()
        for i in np.nonzero(pa)[0]:
            a, t = int(pairing1[i]), int(pi[i])
            b = int(pairing2[t]) if 0 <= t < len(pairing2) else -1
            prog.add((a, b, int(pd[i])) if a >= 0 and b >= 0 else ("unpaired", int(i)))
        self.pairs += 1
        self.ref_matches += len(ref)
        self.matches_off += len(ref ^ prog)

    def pixels(self, staged: np.ndarray, handed: np.ndarray):
        self.pixels_off = (self.pixels_off or 0) + int((staged != handed).any(-1).sum())

    def compared(self) -> str:
        return (f"compared {self.ref_kp} reference keypoints ({self.paired} paired), "
                f"{self.ref_matches} reference matches in {self.pairs} pairs"
                + ("" if self.pixels_off is None else ", staged frames' pixels"))

    def numbers(self) -> dict:
        out = dict(
            keypoints_unpaired_pct=100.0 * self.unpaired / max(1, self.ref_kp),
            descriptor_bytes_off_pct=100.0 * self.bytes_off / max(1, 128 * self.paired),
        )
        if self.pairs:
            out["matches_off_pct"] = 100.0 * self.matches_off / max(1, self.ref_matches)
        if self.pixels_off is not None:
            out["pixels_off"] = self.pixels_off
        return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """(every number within its limit, one line per number).  A number
    without a limit, or a limit without its number, fails."""
    lines, ok = [], True
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        good = v is not None and lim is not None and v <= lim
        ok &= good
        lines.append(f"{name} {v!r} limit {lim!r} {'ok' if good else 'FAIL'}")
    return ok, lines
