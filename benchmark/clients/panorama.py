"""One panorama a request, as ``python -m sift_tpu_torch stitch`` computes
it (``cli.stitch_main``), in memory: every frame of the request, flipped
and as a float32 host array (what ``utils/io.load_image`` gives the
command), goes to the entry point ``models/sift.detect_and_describe_batch``
alone (batch 1, ``return_counts``); then the frames and their keypoints go
through the two calls of ``models/stitch.stitch_scene`` over the chain
graph (``chain_graph``, the command's graph for a scene without a graph
file): ``solve_edge_homographies`` with the configuration's
``num_hypotheses``, then ``compose_scene``.  The request ends when the
float32 canvas is a host array; no PNG is written.  The capacity check
runs once, after the panorama, over every frame's counts.

The judge compares a sampled request's answers with the plain reference
(``reference/sift_plain``'s keypoints, ``match_plain``'s matches,
``reference/stitch_plain``'s RANSAC and canvas): each frame's keypoints
and descriptor bytes and each edge's matches (those the request's
``solve_edge_homographies`` computed) as the other cells do, and
``Tally``'s two numbers of the stitching, each of which moves smoothly
with its inputs:

* the request's edge homographies, by how many of the reference's RANSAC
  inliers (its matches within the inlier threshold of its homography)
  they keep within the threshold: a sound program whose rounding makes
  RANSAC take another of the near-tied hypotheses keeps nearly all;
* the request's canvas, against the reference's canvas composed from the
  request's own edge homographies, so that it tests the chaining, layout,
  gains and blend alone.

``program``, for the control and the tests: (detect, match[, stitch]) in
the entry points' place; ``stitch(images, kps)`` -> (edge homographies,
canvas) also takes the stitching's (the judge then matches the request's
keypoints with ``match``).
"""

from __future__ import annotations

import contextlib
import types

import numpy as np
import torch

from benchmark import clients, judge, traffic
from benchmark.reference import stitch_plain

# A canvas pixel is off when a channel lies more than this many grey
# levels from the reference's.
GREY_LEVELS = 1.0


class Tally(judge.Tally):
    """``judge.Tally`` and the stitching's numbers:

    * ``homography_inliers_lost_pct``: over the edges, the largest share
      of the reference's RANSAC inliers that lie outside the inlier
      threshold of the program's homography, per 100 (0 where it keeps
      them all);
    * ``panorama_pixels_off_pct``: canvas pixels with a channel more than
      ``GREY_LEVELS`` off the reference's canvas of the program's edge
      homographies (or not finite), per 100 pixels; 100 where the shapes
      differ."""

    def __init__(self):
        super().__init__()
        self.edges = 0
        self.lost_pct = 0.0
        self.canvases = self.px_off = self.px = 0

    def homographies(self, prog: dict, ref: dict, inliers: dict, threshold: float):
        """``prog`` / ``ref``: {(frame, parent): (3, 3)} edge homographies;
        ``inliers``: {(frame, parent): ((n, 2), (n, 2))}, the reference's
        matched points of the frame and of its parent."""
        for e, (p1, p2) in inliers.items():
            kept_ref = within(ref[e], p1, p2, threshold)
            kept = within(prog[e], p1[kept_ref], p2[kept_ref], threshold)
            n = int(kept_ref.sum())
            lost = 100.0 * (n - int(kept.sum())) / n if n else 0.0
            self.lost_pct = max(self.lost_pct, lost)
            self.edges += 1

    def canvas(self, prog: np.ndarray, ref: np.ndarray):
        self.canvases += 1
        self.px += ref.shape[0] * ref.shape[1]
        if prog.shape != ref.shape:
            self.px_off += ref.shape[0] * ref.shape[1]
            return
        for r in range(0, ref.shape[0], 512):
            d = np.abs(prog[r:r + 512] - ref[r:r + 512])
            self.px_off += int((~(d <= GREY_LEVELS)).any(-1).sum())

    def compared(self) -> str:
        return super().compared() + (
            f", {self.edges} edge homographies, {self.canvases} canvases of {self.px} pixels"
            if self.canvases else "")

    def numbers(self) -> dict:
        out = super().numbers()
        if self.canvases:
            out.update(homography_inliers_lost_pct=self.lost_pct,
                       panorama_pixels_off_pct=100.0 * self.px_off / max(1, self.px))
        return out


def within(h, p1: np.ndarray, p2: np.ndarray, threshold: float) -> np.ndarray:
    """(n,) bool: ``p1`` maps through ``h`` within ``threshold`` pixels of
    ``p2``, in float64 (not finite: outside)."""
    h = np.asarray(h, np.float64)
    q = np.concatenate([p1, np.ones((len(p1), 1))], 1) @ h.T
    with np.errstate(all="ignore"):
        d2 = ((q[:, :2] / q[:, 2:] - p2) ** 2).sum(1)
        return d2 < threshold * threshold


@contextlib.contextmanager
def kept_matches():
    """A list that gathers the answers (index, accepted, best distance) of
    every call of ``models/match.match_descriptors`` made inside the block
    (the stitching's matcher looks it up at each call), left on the card."""
    from sift_tpu_torch.models import match

    call, out = match.match_descriptors, []

    def keep(*a, **k):
        answer = call(*a, **k)
        out.append(answer[:3])
        return answer

    match.match_descriptors = keep
    try:
        yield out
    finally:
        match.match_descriptors = call


def one_frame(kp):
    """Frame 0 of a batch's keypoints, as the command takes it."""
    if hasattr(kp, "map"):
        return kp.map(lambda a: a[0])
    return types.SimpleNamespace(**{k: getattr(kp, k)[0] for k in judge.FIELDS + ("desc", "valid")})


def all_counts(counts: list) -> dict:
    """The frames' ``return_counts`` dicts as one batch's."""
    return {k: torch.cat([c[k].reshape(1, *c[k].shape[1:]) for c in counts]) for k in counts[0]}


class Client(clients.Client):
    def __init__(self, cell, frames, dev, spans, seconds: float, program=None):
        super().__init__(cell, frames, dev, spans, seconds, program[:2] if program else None)
        from sift_tpu_torch.utils.stitch_graph import chain_graph

        self.params = cell.config["stitch"]
        self.graph = chain_graph(len(frames))
        self.edges = [(i, p) for i, p in self.graph.bfs_parents().items() if i != p]
        self.stitch = program[2] if program and len(program) > 2 else self.stitch_scene
        self.scenes: dict = {}

    def stitch_scene(self, images, kps):
        """``stitch_scene``'s two calls: (edge homographies, canvas, the
        edges' matches)."""
        from sift_tpu_torch.models.stitch import compose_scene, solve_edge_homographies

        with kept_matches() as matches:
            h_edge = solve_edge_homographies(kps, self.graph, self.cfg,
                                             self.params["num_hypotheses"])
        pano = compose_scene(images, self.graph, h_edge, seam_aware=self.params["seam_aware"],
                             device=self.dev)
        return h_edge, pano, matches

    def setup(self, reqs):
        """Each flip's scene as float32 host arrays."""
        for flip in range(4):
            self.scenes[flip] = [traffic.flipped(f, flip).astype(np.float32) for f in self.frames]
        return reqs

    def request(self, req) -> dict:
        images = [self.scenes[req["flip"]][i] for i in req["frames"]]
        kps, counts = [], []
        for img in images:
            with self.spans("entry", 1):
                kp, c = self.detect(img[None], self.cfg, return_counts=True, device=self.dev)
            kps.append(one_frame(kp))
            counts.append(c)
        with self.spans("stitch", len(images)):
            h_edge, pano, *matches = self.stitch(images, kps)
        with self.spans("check"):
            bad = clients.clipped(all_counts(counts), self.cfg)
        return dict(frames=len(images), pairs=len(self.edges), bad=bad, kps=kps, h_edge=h_edge,
                    pano=pano, matches=matches[0] if matches else None)

    def close(self):
        self.scenes.clear()

    def edge_matches(self, s, kps, i: int, p: int):
        """Edge (i, p)'s (index, accepted, best distance) on the host: the
        request's (its matcher's calls ran in the order of its edge
        homographies), else the matcher's on the request's keypoints."""
        if s["matches"] is not None:
            n = list(s["h_edge"]).index((i, p))
            return [a.cpu().numpy() for a in s["matches"][n]]
        out = self.match(kps[i].desc[None], kps[i].valid[None], kps[p].desc[None],
                         kps[p].valid[None], self.cfg.ratio_threshold, device=self.dev)[:3]
        return [a[0].cpu().numpy() for a in out]

    def judge(self, samples, reference) -> judge.Tally:
        tally = Tally()
        ratio, lanes = self.cfg.ratio_threshold, self.cfg.ori_cap
        for s in samples:
            req = s["req"]
            keys = [(i, req["flip"]) for i in req["frames"]]
            kps = s["kps"]
            valid = [kp.valid.cpu().numpy() for kp in kps]
            pairing = [tally.frame({k: getattr(kp, k).cpu().numpy()[v] for k in
                                    judge.FIELDS + ("desc",)}, reference(key))
                       for kp, v, key in zip(kps, valid, keys)]
            for i, p in self.edges:
                prog = clients.valid_order(*self.edge_matches(s, kps, i, p), valid[i], valid[p])
                tally.matches(prog, pairing[i], pairing[p],
                              clients.plain_matches(reference, keys[i], keys[p], ratio))
            refs = [reference(key) for key in keys]
            plain = [dict(x=r["x"], y=r["y"], desc=r["desc_t"]) for r in refs]
            m_ref = stitch_plain.edge_matches(plain, lanes, ratio, reference.dev)
            h_ref = stitch_plain.edge_homographies(plain, self.params, lanes, ratio,
                                                   reference.dev, matches=m_ref)
            tally.homographies(s["h_edge"], h_ref,
                               {e: (p1[c].cpu().numpy().astype(np.float64),
                                    p2[c].cpu().numpy().astype(np.float64))
                                for e, (p1, p2, c) in m_ref.items()},
                               self.params["inlier_threshold"])
            images = [traffic.flipped(self.frames[i], req["flip"]) for i in req["frames"]]
            tally.canvas(s["pano"], stitch_plain.panorama(images, s["h_edge"], self.params,
                                                          reference.dev))
        return tally

    def work(self, records) -> dict:
        return dict(frames=sum(r["frames"] for r in records), requests=len(records),
                    frame_shape=self.frames[0].shape)
