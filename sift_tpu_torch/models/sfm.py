"""Incremental structure-from-motion (the JAX package's ``models/sfm.py``).

Pipeline: detect + describe (models/sift) -> pairwise ratio matching
(models/match) -> per-pair geometric verification (GRIC, H against E) ->
feature tracks (host union-find) -> two-view initialization
(ransac_essential + recover_pose + triangulation) -> incremental
registration (ransac_pnp) + new-track triangulation -> global
Schur-complement BA (models/ba); on long sequences a gated loop-closure
repair (pose-graph relaxation, motion-prior fill, a refine-mode second
solve).

The geometry and BA run on the caller's device; the track bookkeeping is
host numpy, as in the JAX package, and so is ``pose_graph_relax``'s solve
(see there).  Where the JAX package hands float64 numpy to ``jnp.asarray``
without a dtype, it computes in float32 in production (x64 off); the port
computes in float32 there too.  The core driver is match-driven
(``run_sfm_from_matches``) so tests can feed synthetic correspondences with
ground truth; ``run_sfm`` wraps it with real detection and matching.

The tracks are listed once (``_track_groups``), then indexed by frame
(``_TrackIndex``): the registration's candidate counts, PnP's candidates,
the triangulation's new tracks and partners, the BA's observation rows and
the initial pair's shared-track tally read those arrays, not a pass over
every track, with the JAX package's orders and tie rules.

Its spans (``sfm.<stage>``, the host waits ``sfm.sync.<kind>``) and
counters are listed in ``utils/profiling``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.models.ba import (
    _residuals,
    ba_problem_from_numpy,
    ba_solve,
    build_obs_by_point,
)
from sift_tpu_torch.models import geometry
from sift_tpu_torch.models.geometry import (
    _sampson_err2,
    mat_vecs,
    matmul3,
    ransac_essential,
    ransac_essential_with_samples,
    ransac_pnp,
    recover_pose,
    rodrigues,
    triangulate,
)
from sift_tpu_torch.models.match import match_descriptors
from sift_tpu_torch.models.sift import detect_and_describe_batch
from sift_tpu_torch.models.stitch import _apply_h, ransac_with_samples
from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.numerics import resolve_device

RANSAC_HYPOTHESES = 1024
_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class SfmResult:
    poses: np.ndarray        # (C, 6) [rvec, tvec], x_cam = R X + t
    points: np.ndarray       # (P, 3)
    track_point: np.ndarray  # (T,) index into points or -1
    info: dict


def _track_groups(pair_matches, min_track_len: int = 2) -> list[list[tuple[int, int]]]:
    """The tracks of the pairs' matches as the JAX package keeps its
    union-find's groups, on arrays: a union of (i, a) and (j, b) for every
    match in order, then the groups in the order of their first
    observation's first union (its ``_Tracks.groups``' order), each
    sorted, without those shorter than ``min_track_len`` or with two
    observations in one frame.  The components come from minimum-label
    propagation with pointer jumping over the match edges."""
    ends = []
    for (i, j), m in pair_matches.items():
        m = np.asarray(m, np.int64).reshape(-1, 2)
        ends.append(np.stack([np.stack([np.full(len(m), i), m[:, 0]], 1),
                              np.stack([np.full(len(m), j), m[:, 1]], 1)], 1).reshape(-1, 2))
    seq = np.concatenate(ends) if ends else np.zeros((0, 2), np.int64)
    if not len(seq):
        return []
    width = int(seq[:, 1].max()) + 1
    keys, first, node = np.unique(seq[:, 0] * width + seq[:, 1], return_index=True,
                                  return_inverse=True)
    a, b = node[0::2], node[1::2]
    label = np.arange(len(keys))
    while True:
        new = label.copy()
        low = np.minimum(label[a], label[b])
        np.minimum.at(new, a, low)
        np.minimum.at(new, b, low)
        new = new[new]
        if np.array_equal(new, label):
            break
        label = new
    # each component's first appearance orders it; its members by (frame, feature)
    met = np.full(len(keys), len(seq))
    np.minimum.at(met, label, first)
    order = np.lexsort((keys, met[label]))
    comp = label[order]
    cut = np.nonzero(comp[1:] != comp[:-1])[0] + 1
    frames, feats = (keys[order] // width).tolist(), (keys[order] % width).tolist()
    out = []
    for lo, hi in zip(np.concatenate([[0], cut]).tolist(), np.append(cut, len(order)).tolist()):
        if hi - lo >= min_track_len and len(set(frames[lo:hi])) == hi - lo:
            out.append(list(zip(frames[lo:hi], feats[lo:hi])))
    return out


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The concatenated ``arange(s, s + n)`` of each (start, length)."""
    ends = np.cumsum(lens)
    return np.arange(ends[-1] if len(ends) else 0) - np.repeat(ends - lens - starts, lens)


class _TrackIndex(list):
    """The tracks (a list of sorted (frame, feature) lists, which it is)
    indexed by frame, built once per track list:

    * ``obs_t``, ``obs_f``, ``obs_feat``, ``obs_uv``: every observation, in
      track order and within a track in frame order (``obs_uv`` float64);
    * ``row``: (tracks, frames) observation row of each track in each frame,
      -1 where the track is absent; ``by_frame[f]``: the tracks in frame
      ``f``, ascending;
    * ``cand``: each frame's tracks that hold a point, kept up to date by
      ``gained`` as tracks get their points.
    """

    def __init__(self, track_obs, n_frames: int, uv_of=None, keypoints_uv=None):
        super().__init__(track_obs)
        lens = np.fromiter((len(g) for g in track_obs), np.int64, len(track_obs))
        self.n_frames = n_frames
        self.start = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        flat = np.asarray([o for g in track_obs for o in g], np.int64).reshape(-1, 2)
        self.obs_t = np.repeat(np.arange(len(track_obs)), lens)
        self.obs_f, self.obs_feat = flat[:, 0], flat[:, 1]
        self.obs_uv = np.zeros((len(flat), 2))
        if keypoints_uv is not None:
            for f in range(n_frames):
                at = np.nonzero(self.obs_f == f)[0]
                if len(at):
                    self.obs_uv[at] = np.asarray(keypoints_uv[f], np.float64)[self.obs_feat[at]]
        elif len(flat):
            self.obs_uv[:] = [uv_of(int(f), int(x)) for f, x in flat]
        self.row = np.full((len(track_obs), n_frames), -1, np.int64)
        self.row[self.obs_t, self.obs_f] = np.arange(len(flat))
        self.by_frame = [np.nonzero(self.row[:, f] >= 0)[0] for f in range(n_frames)]
        self.cand = np.zeros(n_frames, np.int64)

    def gained(self, ts) -> None:
        """Tracks ``ts`` just got their points: one candidate more in each
        of their frames."""
        ts = np.asarray(ts, np.int64)
        rows = _ranges(self.start[ts], self.start[ts + 1] - self.start[ts])
        self.cand += np.bincount(self.obs_f[rows], minlength=self.n_frames)

    def candidates(self, f: int, track_point: np.ndarray):
        """(tracks, observation rows) of frame ``f``'s tracks that hold a
        point, in track order."""
        ts = self.by_frame[f]
        ts = ts[track_point[ts] >= 0]
        return ts, self.row[ts, f]

    def pair_tally(self):
        """The frame pairs that tracks share, in the order in which a pass
        over the tracks (each track's pairs in frame order) first meets
        them: (pairs (K, 2), rows of frame a (M,), rows of frame b (M,),
        bounds (K + 1,)): pair k's tracks' observation rows are
        ``[bounds[k]:bounds[k + 1]]`` of the row arrays, in track order."""
        # every (row a, row b > a) of one track, in (a, b) order: that pass's
        n_obs = len(self.obs_t)
        c = self.start[1:][self.obs_t] - 1 - np.arange(n_obs)
        ra = np.repeat(np.arange(n_obs), c)
        rb = ra + 1 + _ranges(np.zeros(n_obs, np.int64), c)
        key = self.obs_f[ra] * self.n_frames + self.obs_f[rb]
        if len(key) == 0:
            return np.zeros((0, 2), np.int64), ra, rb, np.zeros(1, np.int64)
        if self.n_frames * self.n_frames <= 2**16:  # a stable sort of 16-bit keys is a radix sort
            key = key.astype(np.uint16)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        starts = np.concatenate([[0], np.nonzero(ks[1:] != ks[:-1])[0] + 1])
        counts = np.diff(np.append(starts, len(ks)))
        met = np.argsort(order[starts], kind="stable")
        by = order[_ranges(starts[met], counts[met])]
        pairs = ks[starts][met].astype(np.int64)
        return (np.stack([pairs // self.n_frames, pairs % self.n_frames], 1), ra[by], rb[by],
                np.concatenate([[0], np.cumsum(counts[met])]))


def _normalize(uv: np.ndarray, k: np.ndarray) -> np.ndarray:
    return (uv - k[[0, 1], [2, 2]]) / k[[0, 1], [0, 1]]


def _wait(kind: str, dev):
    """The span ``sfm.sync.<kind>`` of a host wait for the card ``dev``
    (none on the CPU, where nothing waits)."""
    return profiling.span(f"sfm.sync.{kind}") if torch.device(dev).type != "cpu" else _NULL


def _f32(a, dev) -> torch.Tensor:
    """Host numbers -> float32 on ``dev``, rounded to nearest (``jnp.asarray
    (a, jnp.float32)``)."""
    with _wait("upload", dev):
        return torch.as_tensor(np.asarray(a), device=dev).to(torch.float32)


def _mask(v, dev) -> torch.Tensor:
    """A host mask on ``dev``."""
    with _wait("upload", dev):
        return torch.as_tensor(v, device=dev)


def _host(t: torch.Tensor, kind: str) -> np.ndarray:
    """``t`` as numpy, the host's wait for it marked ``sfm.sync.<kind>``."""
    with _wait(kind, t.device):
        return t.cpu().numpy()


def _rot(rvecs, dev) -> np.ndarray:
    """Rotation matrices of (..., 3) rotation vectors: ``rodrigues`` in
    float32 on ``dev``, returned as float64 numpy."""
    return _host(rodrigues(_f32(rvecs, dev)), "rotation").astype(np.float64)


def _upload_parts(parts, dev) -> list[torch.Tensor]:
    """Host arrays -> float32 views of one buffer on ``dev``, rounded to
    nearest as ``_f32`` rounds, in one copy staged through pinned memory on
    the card (one ``sfm.sync.upload`` span)."""
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in parts])
    with _wait("upload", dev):
        buf = torch.from_numpy(flat)
        if torch.device(dev).type == "cuda":
            buf = buf.pin_memory().to(dev, non_blocking=True)
    ends = np.cumsum([0] + [a.size for a in parts]).tolist()
    return [buf[lo:hi].view(a.shape) for a, lo, hi in zip(parts, ends, ends[1:])]


# Pairs a launch chain takes at most: their (P, K, cap, 2) float32
# intermediates stay under about 2 GB.
_CHAIN_BYTES = 2 << 30


def _geometric_verify(
    keypoints_uv, pair_matches, k, seed, thr: float = 2e-3, min_inl: int = 12,
    sigma_px: float = 1.0, keep_sigma: float = 2.0,
    stats: dict | None = None, device="cuda",
):
    """Per-pair geometric verification with GRIC H-vs-E model selection.

    Raw ratio-test matches contain repeated-texture confusions (the same
    patch on two scene planes); letting them into the union-find merges
    tracks across physically distinct points.  Fit BOTH an essential matrix
    and a homography per pair and compare Torr's criterion

        GRIC_M = sum_i rho_M(e_i^2 / sigma^2) + lam1 * d_M * n + lam2 * k_M,
        rho_M(x) = min(x, 2 * (r - d_M)),  r = 4,
        (d, k) = (3, 5) for E, (2, 8) for H,
        lam1 = log(r), lam2 = log(r * n)

    (P.H.S. Torr, CVPR 1997); the pair keeps the matches inside EITHER
    model's 2-sigma band.  Near-static pairs (median disparity < 1.5 px)
    skip straight to H: they are exactly H-modeled and E is maximally
    degenerate.  Both RANSACs run on ``device`` with the seed
    ``seed + 7 * i + j``.

    The pairs are verified together: those of one lane count (``cap``)
    share one upload and one launch chain a model (the RANSAC functions'
    pair axis), and every pair's errors come back in one host read; each
    pair's numbers are those of its own call (bit for bit on the CPU).
    """
    dev = resolve_device(device)
    f_mean = float(np.sqrt(k[0, 0] * k[1, 1]))
    sig2 = sigma_px * sigma_px
    lam1 = float(np.log(4.0))
    # Keep band: 2 sigma, decoupled from the RANSAC fit bands (the JAX
    # package's calibration on its rendered evaluation).
    keep2 = (keep_sigma * sigma_px) ** 2
    kh = RANSAC_HYPOTHESES

    # Host side: each pair's lanes, and whether it is near-static.
    jobs, groups = {}, {}
    for (i, j), m in pair_matches.items():
        if len(m) < 16:
            continue
        p1 = keypoints_uv[i][m[:, 0]]
        p2 = keypoints_uv[j][m[:, 1]]
        n_m = len(m)
        cap = max(64, 1 << int(np.ceil(np.log2(n_m))))
        # Revisited / static viewpoint: E is degenerate by construction, H
        # is the exact model: no E fit and no GRIC.
        static = bool(np.median(np.linalg.norm(p2 - p1, axis=1)) < 1.5)
        jobs[(i, j)] = dict(p1=p1, p2=p2, n=n_m, static=static, seed=seed + 7 * i + j)
        groups.setdefault(cap, []).append((i, j))

    # One upload a lane count, then one launch chain a model and chunk: the
    # pairs that fit E first, so they are a leading slice of the stack.
    reads = []
    for cap, keys in groups.items():
        keys.sort(key=lambda key: jobs[key]["static"])
        n_e = sum(not jobs[key]["static"] for key in keys)
        u1, u2, q1, q2 = np.zeros((4, len(keys), cap, 2))
        v = np.zeros((len(keys), cap))
        for r, key in enumerate(keys):
            job, n_m = jobs[key], jobs[key]["n"]
            u1[r, :n_m], u2[r, :n_m] = job["p1"], job["p2"]
            q1[r, :n_m], q2[r, :n_m] = _normalize(job["p1"], k), _normalize(job["p2"], k)
            v[r, :n_m] = 1.0
        u1_t, u2_t, q1_t, q2_t, v_t = _upload_parts([u1, u2, q1, q2, v], dev)
        v_t = v_t > 0
        step = max(1, _CHAIN_BYTES // (kh * cap * 2 * 4))
        for lo in range(0, len(keys), step):
            hi = min(lo + step, len(keys))
            e_hi = max(lo, min(hi, n_e))
            chain = _verify_chain([jobs[key]["seed"] for key in keys[lo:hi]], u1_t[lo:hi],
                                  u2_t[lo:hi], q1_t[lo:e_hi], q2_t[lo:e_hi], v_t[lo:hi], thr,
                                  sigma_px, stats is not None)
            reads.append((keys[lo:hi], chain))

    # One host read of every pair's errors (and inlier counts), then GRIC
    # and the keep bands per pair on the host.
    if reads:
        parts = [t for _, chain in reads for t in chain]
        flat = _host(torch.cat([t.reshape(-1).to(torch.float32) for t in parts]), "verify")
        pieces = iter(np.split(flat, np.cumsum([t.numel() for t in parts])[:-1]))
        for keys, chain in reads:
            proj, err_e, *counts = (next(pieces).reshape(t.shape) for t in chain)
            for r, key in enumerate(keys):
                job = jobs[key]
                n_m = job["n"]
                job["err2_h"] = ((proj[r, :n_m] - job["p2"].astype(np.float64)) ** 2).sum(1)
                if r < len(err_e):
                    job["err2_e"] = err_e[r, :n_m] * (f_mean * f_mean)
                if counts:
                    job["h_inl"] = int(counts[0][r])
                    job["e_inl"] = int(counts[1][r]) if r < len(err_e) else None

    out = {}
    for key, m in pair_matches.items():
        job = jobs.get(key)
        if job is None:
            out[key] = m
            continue
        err2_h = job["err2_h"]
        if job["static"]:
            keep = err2_h < keep2
            if int(keep.sum()) >= min_inl:
                out[key] = m[keep]
            continue
        # Sampson distance in normalized units -> px^2 via the mean focal.
        err2_e, n_m = job["err2_e"], job["n"]
        lam2 = float(np.log(4.0 * n_m))
        gric_e = (np.minimum(err2_e / sig2, 2.0 * (4 - 3)).sum()
                  + lam1 * 3 * n_m + lam2 * 5)
        gric_h = (np.minimum(err2_h / sig2, 2.0 * (4 - 2)).sum()
                  + lam1 * 2 * n_m + lam2 * 8)
        if stats is not None:
            stats[key] = dict(
                model=("H" if gric_h < gric_e else "E"),
                gric_e=float(gric_e), gric_h=float(gric_h), n=n_m,
                e_inl=job["e_inl"], h_inl=job["h_inl"],
            )
        # The UNION of both models' keep bands: each model has structure
        # the other cannot represent (H: off-plane parallax; E: planar or
        # rotation-dominant sets); a repeated-texture confusion sits far
        # outside both.
        keep = (err2_e < keep2) | (err2_h < keep2)
        if int(keep.sum()) >= min_inl:
            out[key] = m[keep]
        # else: drop the pair entirely (no consistent geometry)
    return out


def _verify_chain(seeds, u1, u2, q1, q2, v, thr, sigma_px, counts):
    """One launch chain a model over a stack of pairs of one lane count:
    the homography RANSAC over all of them (pixel space, 2 px), the
    essential RANSAC over the first ``len(q1)`` (normalized space, ``thr``),
    each pair on its own draws (``geometry.sample_choice`` at its seed,
    looked up at the call).  Returns the device tensors to read: the
    projections of ``u1`` through each H, each E's Sampson errors, and with
    ``counts`` both models' inlier counts."""
    kh, cap, n_e = RANSAC_HYPOTHESES, u1.shape[1], len(q1)
    profiling.count("sfm.verify_pairs", len(seeds))
    profiling.count("sfm.verify_chains", 1 + (n_e > 0))
    profiling.count("sfm.ransac_lanes", (len(seeds) + n_e) * kh * cap)
    idx_h = torch.stack([geometry.sample_choice(v[r], kh, 4, s) for r, s in enumerate(seeds)])
    h, _, h_cnt = ransac_with_samples(u1, u2, v, idx_h, 2.0 * sigma_px)
    err_e, e_cnt = u1.new_zeros((0, cap)), h_cnt[:0]
    if n_e:
        idx_e = torch.stack([geometry.sample_choice(v[r], kh, 8, s)
                             for r, s in enumerate(seeds[:n_e])])
        e, _, e_cnt = ransac_essential_with_samples(q1, q2, v[:n_e], idx_e, thr)
        err_e = _sampson_err2(e, q1, q2)
    return [_apply_h(h, u1), err_e] + ([h_cnt, e_cnt] if counts else [])


def _observations(tix, track_point, registered):
    """The (cam, point, uv) rows of every triangulated track of the
    ``_TrackIndex`` ``tix`` in the registered frames, in track order and
    within a track in frame order."""
    reg = np.zeros(tix.n_frames, bool)
    reg[np.asarray(registered, np.int64)] = True
    keep = (track_point[tix.obs_t] >= 0) & reg[tix.obs_f]
    return (tix.obs_f[keep].astype(np.int32), track_point[tix.obs_t[keep]].astype(np.int32),
            tix.obs_uv[keep])


def _problem(poses, pts, obs_cam, obs_pt, obs_uv, fixed, fxy, cxy, dev):
    """The float32 ``BAProblem`` the JAX package builds from host arrays."""
    f32 = np.float32
    return ba_problem_from_numpy(dict(
        cams=poses.astype(f32), points=pts.astype(f32), obs_cam=obs_cam, obs_pt=obs_pt,
        obs_uv=obs_uv.astype(f32), obs_mask=np.ones(len(obs_cam), bool),
        obs_by_point=build_obs_by_point(obs_pt, len(pts)),
        fxy=fxy.astype(f32), cxy=cxy.astype(f32), fixed_cams=fixed), dev)


def _ba_pass(
    n_frames, poses, points, track_obs, track_point, registered,
    fa, fb, fxy, cxy, uv_of, iters, device="cuda",
):
    """One bundle-adjustment pass over the currently registered frames.

    Returns (poses, points-list) updated in the same containers' formats.
    ``track_obs``: a ``_TrackIndex``, or the track list.
    """
    pts = np.asarray(points)
    if not isinstance(track_obs, _TrackIndex):
        track_obs = _TrackIndex(track_obs, n_frames, uv_of)
    obs_cam, obs_pt, obs_uv = _observations(track_obs, track_point, registered)
    if len(obs_cam) < 12 or len(pts) < 8:
        return poses, points
    fixed = np.ones(n_frames, bool)  # unregistered cams must not move
    for f in registered:
        fixed[f] = False
    fixed[fa] = True
    fixed[fb] = True  # freezes gauge incl. scale
    pr = _problem(poses, pts, obs_cam, obs_pt, obs_uv, fixed, fxy, cxy, resolve_device(device))
    with profiling.span("sfm.ba"):
        cams_opt, pts_opt, _ = ba_solve(pr, iters, huber_delta=3.0)
    return (_host(cams_opt, "ba").astype(np.float64),
            list(_host(pts_opt, "ba").astype(np.float64)))


def _register_frame(
    f, tix, track_point, points, poses, registered, k, seed, device="cuda",
) -> bool:
    """PnP-register frame ``f`` against the current map (consensus-gated):
    its candidates are the frame's tracks that hold a point, in track
    order (``_TrackIndex.candidates``).

    Returns False (leaving ``poses``/``registered`` untouched) when the
    frame has too few 2D-3D candidates or a weak consensus: callers
    re-queue it and retry after more neighbors register.
    """
    dev = resolve_device(device)
    ts, rows = tix.candidates(f, track_point)
    if len(ts) < 8:
        return False
    n_cand = len(ts)
    cap_f = max(64, 1 << int(np.ceil(np.log2(n_cand))))
    x3 = np.zeros((cap_f, 3))
    x2 = np.zeros((cap_f, 2))
    v = np.zeros(cap_f, bool)
    x3[:n_cand] = [points[p] for p in track_point[ts]]
    x2[:n_cand] = _normalize(tix.obs_uv[rows], k)
    v[:n_cand] = True
    profiling.count("sfm.ransac_lanes", RANSAC_HYPOTHESES * cap_f)
    rvec, tvec, _, cnt = ransac_pnp(_f32(x3, dev), _f32(x2, dev), _mask(v, dev),
                                    RANSAC_HYPOTHESES, 8e-3, seed + f)
    # Gate on PnP consensus: a frame with essentially no inliers would
    # seed triangulation and BA with a garbage pose.
    if int(_host(cnt, "pnp")) < max(6, n_cand // 10):
        return False
    poses[f, :3] = _host(rvec, "pnp").astype(np.float64)
    poses[f, 3:] = _host(tvec, "pnp").astype(np.float64)
    registered.append(f)
    return True


def _partners(f, tix, track_point, registered, uv_of):
    """(track, partner frame, partner's row, f's row) of each of frame
    ``f``'s tracks that hold no point, in track order, that has a partner.

    Partner = the max-disparity frame of ``registered[:-1]`` (the first in
    that order on a tie), skipping near-zero baselines (a revisited
    viewpoint pairs almost-identical frames; triangulating them puts
    garbage points at quasi-infinite depth that survive cheirality).  The
    0.75 px floor only skips near-identical viewpoints.  The disparity is
    ``uv_of``'s, in its dtype."""
    pos = {rf: n for n, rf in enumerate(registered[:-1])}
    ts = tix.by_frame[f]
    new = []
    for t in ts[track_point[ts] < 0].tolist():
        a, b = tix.start[t], tix.start[t + 1]
        frames = tix.obs_f[a:b].tolist()
        feats = tix.obs_feat[a:b].tolist()
        uv_f = uv_of(f, feats[frames.index(f)])
        best_pf, best_d = -1, 0.0
        for _, rf, feat in sorted((pos[g], g, x) for g, x in zip(frames, feats) if g in pos):
            d = float(np.linalg.norm(uv_of(rf, feat) - uv_f))
            if d > best_d:
                best_pf, best_d = rf, d
        if best_pf >= 0 and best_d >= 0.75:
            new.append((t, best_pf, tix.row[t, best_pf], tix.row[t, f]))
    return new


def _triangulate_new(
    f, tix, track_point, points, poses, registered, uv_of, k, device="cuda",
) -> None:
    """Triangulate tracks newly observable from freshly-registered ``f``,
    each with its partner (``_partners``).  All of the frame's new tracks
    are triangulated in one batch on ``device`` (each row its own partner
    pose).
    """
    dev = resolve_device(device)
    new = _partners(f, tix, track_point, registered, uv_of)
    if not new:
        return
    q1 = _normalize(tix.obs_uv[[r for _, _, r, _ in new]], k)
    q2 = _normalize(tix.obs_uv[[r for _, _, _, r in new]], k)
    pfs = [pf for _, pf, _, _ in new]
    rots = _rot(np.concatenate([poses[pfs, :3], poses[f:f + 1, :3]]), dev)
    r1s, rf = rots[:-1], rots[-1]
    t1s = poses[pfs, 3:]
    xn = triangulate(_f32(q1, dev), _f32(q2, dev), _f32(r1s, dev), _f32(t1s, dev),
                     _f32(rf, dev), _f32(poses[f, 3:], dev))
    xn = _host(xn, "triangulate").astype(np.float64)
    got = []
    for n, (t, _, _, _) in enumerate(new):
        # Cheirality in both views.
        xc1 = r1s[n] @ xn[n] + t1s[n]
        xc2 = rf @ xn[n] + poses[f, 3:]
        if xc1[2] > 0.05 and xc2[2] > 0.05 and np.isfinite(xn[n]).all():
            track_point[t] = len(points)
            points.append(xn[n])
            got.append(t)
    tix.gained(got)


def _so3_log(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle (autodiff-stable).

    theta = atan2(|vee(R - R^T)| / 2, (tr R - 1) / 2); the theta/sin(theta)
    factor is series-expanded near 0 so Gauss-Newton Jacobians stay finite.
    """
    v = 0.5 * torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                           r[..., 1, 0] - r[..., 0, 1]], -1)
    # Guard the norm BEFORE the sqrt: d(sqrt)/dx at 0 is inf, and a residual
    # that is exactly identity at the linearization point (every sequential
    # factor at init) would otherwise poison the whole Jacobian with NaNs.
    s2 = (v * v).sum(-1)
    small = s2 < 1e-12
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    c = 0.5 * (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1.0)
    th = torch.arctan2(torch.where(small, torch.zeros_like(s), s), c)
    scale = torch.where(small, 1.0 + th * th / 6.0, th / s)
    return v * scale[..., None]


def _relative_rotation(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Relative rotation of a (near-)zero-baseline pair from NORMALIZED
    matched coordinates: Kabsch on unit bearings (exact for pure rotation,
    the revisit regime the pose gate admits), with one 3-sigma trim pass
    against ratio-test outliers."""
    b1 = np.concatenate([q1, np.ones((len(q1), 1))], axis=1)
    b2 = np.concatenate([q2, np.ones((len(q2), 1))], axis=1)
    b1 /= np.linalg.norm(b1, axis=1, keepdims=True)
    b2 /= np.linalg.norm(b2, axis=1, keepdims=True)
    r = np.eye(3)
    for _ in range(2):
        h = b2.T @ b1
        u, _, vt = np.linalg.svd(h)
        d = np.sign(np.linalg.det(u @ vt))
        r = u @ np.diag([1.0, 1.0, d]) @ vt
        ang = np.linalg.norm(b2 - (r @ b1.T).T, axis=1)
        thr = max(3.0 * float(np.median(ang)), 1e-4)
        keep = ang < thr
        if keep.sum() < 8 or keep.all():
            break
        b1, b2 = b1[keep], b2[keep]
    return r


def pose_graph_relax(
    poses: np.ndarray,
    registered: list[int],
    closures: list[tuple[int, int, np.ndarray]],
    n_iters: int = 15,
    w_closure: float = 1.0,
) -> np.ndarray:
    """Pose-graph optimization over sequential + loop-closure constraints.

    Variables: (rvec, camera center) per registered frame.  Residuals:
      - sequential between-factors from the base reconstruction (rotation
        log-residual + local-frame center delta), which hold the locally
        accurate shape;
      - closure factors (i, j, R_meas): rotation to the Kabsch-measured
        relative rotation, center coincidence.
    The first node is pinned (gauge); scale is fixed by the sequential
    center deltas.  Dense Gauss-Newton with LM damping.

    This solve runs on the host's CPU whatever device the rest of the run
    takes: a few hundred variables, the JAX package pins it to its CPU
    backend too.  The residuals are float32 and their Jacobian comes from
    ``torch.func.jacrev`` on CPU tensors; the LM steps are float64 numpy.

    Returns a copy of ``poses`` with registered frames replaced.
    """
    reg = sorted(registered)
    n = len(reg)
    if n < 3 or not closures:
        return poses.copy()
    cpu = torch.device("cpu")
    idx = {f: k for k, f in enumerate(reg)}
    rb = _rot(poses[reg][:, :3], cpu)
    cb = -np.einsum("nij,nj->ni", rb.transpose(0, 2, 1), poses[reg][:, 3:])
    seq_a = np.arange(n - 1)
    seq_b = seq_a + 1
    r_rel_seq = np.stack([rb[b] @ rb[a].T for a, b in zip(seq_a, seq_b)])
    d_seq = np.stack([rb[a] @ (cb[b] - cb[a]) for a, b in zip(seq_a, seq_b)])
    clo = [(idx[i], idx[j], rm) for (i, j, rm) in closures if i in idx and j in idx]
    if not clo:
        return poses.copy()

    p0 = np.concatenate([poses[reg][:, :3], cb], axis=1).astype(np.float32)
    sa, sb = torch.as_tensor(seq_a), torch.as_tensor(seq_b)
    ca = torch.as_tensor(np.asarray([c[0] for c in clo]))
    cb_i = torch.as_tensor(np.asarray([c[1] for c in clo]))
    rrs = _f32(r_rel_seq, cpu)
    dsq = _f32(d_seq, cpu)
    rcl = _f32(np.stack([c[2] for c in clo]), cpu)
    p0t = torch.as_tensor(p0)
    wc = float(np.float32(w_closure))

    def residuals(p):
        p = p.reshape(n, 6)
        rr = rodrigues(p[:, :3])
        c = p[:, 3:]
        # sequential between-factors
        rel = matmul3(rr[sb], rr[sa].transpose(-1, -2))  # R_b R_a^T
        r_rot = _so3_log(matmul3(rrs.transpose(-1, -2), rel))
        r_tr = mat_vecs(rr[sa], (c[sb] - c[sa])[:, None, :])[:, 0] - dsq
        # closure factors
        relc = matmul3(rr[cb_i], rr[ca].transpose(-1, -2))
        c_rot = _so3_log(matmul3(rcl.transpose(-1, -2), relc))
        c_tr = mat_vecs(rr[ca], (c[cb_i] - c[ca])[:, None, :])[:, 0]
        # gauge pin: node 0 fully fixed
        pin = (p[0] - p0t[0]) * 10.0
        return torch.cat([r_rot.reshape(-1), r_tr.reshape(-1),
                          wc * c_rot.reshape(-1), wc * c_tr.reshape(-1), pin])

    jac = torch.func.jacrev(residuals)

    def res_f(x):
        with torch.no_grad():
            return residuals(torch.as_tensor(x)).numpy()

    x = p0.reshape(-1).astype(np.float32)
    lam = 1e-4
    cost = float((res_f(x) ** 2).sum())
    for _ in range(n_iters):
        j = jac(torch.as_tensor(x)).numpy().astype(np.float64)
        r = res_f(x).astype(np.float64)
        jtj = j.T @ j
        g = j.T @ r
        step = np.linalg.solve(jtj + lam * np.eye(len(x)), -g)
        x_new = (x + step).astype(np.float32)
        cost_new = float((res_f(x_new) ** 2).sum())
        if cost_new < cost:
            x, cost = x_new, cost_new
            lam = max(lam * 0.3, 1e-7)
        else:
            lam = min(lam * 10.0, 1e3)
    p_opt = np.asarray(x, np.float64).reshape(n, 6)
    out = poses.copy()
    r_opt = _rot(p_opt[:, :3], cpu)
    for k, f in enumerate(reg):
        out[f, :3] = p_opt[k, :3]
        out[f, 3:] = -r_opt[k] @ p_opt[k, 3:]
    return out


def _fill_unregistered_by_interpolation(
    poses: np.ndarray, registered: list[int], n_frames: int,
    max_dist: int = 4, device="cuda",
) -> tuple[np.ndarray, list[int]]:
    """Motion-prior initialization for frames PnP could not register.

    A frame within ``max_dist`` of registered neighbors is initialized by
    lerping the neighbors' camera centers and rotation vectors (past either
    end: extrapolating the last registered step); the refine pass's Huber
    BA then owns the pose.  Returns (poses, newly_filled).
    """
    reg = sorted(registered)
    if len(reg) < 2:
        return poses, []
    dev = resolve_device(device)
    out = poses.copy()
    rset = set(reg)
    cb = -np.einsum("nij,nj->ni", _rot(poses[reg][:, :3], dev).transpose(0, 2, 1),
                    poses[reg][:, 3:])
    c_of = {f: cb[i] for i, f in enumerate(reg)}
    filled, rvs, centers = [], [], []
    for f in range(n_frames):
        if f in rset:
            continue
        left = max((g for g in reg if g < f), default=None)
        right = min((g for g in reg if g > f), default=None)
        if left is not None and right is not None:
            if right - left > 2 * max_dist:
                continue
            w = (f - left) / (right - left)
            rv = (1 - w) * poses[left, :3] + w * poses[right, :3]
            c = (1 - w) * c_of[left] + w * c_of[right]
        elif left is not None:
            # Extrapolate past the end using the last registered step.
            prev = max((g for g in reg if g < left), default=None)
            if prev is None or f - left > max_dist:
                continue
            step_c = (c_of[left] - c_of[prev]) / max(left - prev, 1)
            step_r = (poses[left, :3] - poses[prev, :3]) / max(left - prev, 1)
            rv = poses[left, :3] + step_r * (f - left)
            c = c_of[left] + step_c * (f - left)
        elif right is not None:
            nxt = min((g for g in reg if g > right), default=None)
            if nxt is None or right - f > max_dist:
                continue
            step_c = (c_of[nxt] - c_of[right]) / max(nxt - right, 1)
            step_r = (poses[nxt, :3] - poses[right, :3]) / max(nxt - right, 1)
            rv = poses[right, :3] - step_r * (right - f)
            c = c_of[right] - step_c * (right - f)
        else:
            continue
        filled.append(f)
        rvs.append(rv)
        centers.append(c)
    if filled:
        rms = _rot(np.stack(rvs), dev)
        for f, rv, c, rm in zip(filled, rvs, centers, rms):
            out[f, :3] = rv
            out[f, 3:] = -rm @ c
    return out, filled


def _candidate_counts(remaining, tix) -> dict[int, int]:
    """Each remaining frame's current count of 2D-3D candidates (its tracks
    that hold a point), as ``_TrackIndex.gained`` keeps it."""
    return {f: int(tix.cand[f]) for f in remaining}


def _init_pair(tix, uv_of) -> tuple[int, int]:
    """Among frame pairs sharing at least 16 tracks, the one with the
    largest median disparity * sqrt(count), the first met on a tie (the
    order of ``_TrackIndex.pair_tally``); (0, 1) when none qualifies.

    Each pair's score is first taken from float64 disparities of the
    index's pixels; the pairs within 1e-5 of the best of those (which
    holds every pair within rounding of the true best) are scored again
    from ``uv_of``'s pixels, in their dtype, as the JAX package scores
    every pair, and the first maximum of those wins."""
    best = (0, min(1, tix.n_frames - 1))
    pairs, ra, rb, bounds = tix.pair_tally()
    count = np.diff(bounds)
    if not (count >= 16).any():
        return best
    # each pair's median disparity: its sorted disparities' middle one or two
    # each pair's median disparity: its sorted disparities' middle one or
    # two, sorted by pair + disparity / span (ulp 1e-9 of it: within 1e-6
    # px of the true order's medians, which the slack below covers)
    d = np.linalg.norm(tix.obs_uv[ra] - tix.obs_uv[rb], axis=1)
    if not np.isfinite(d).all():
        d[~np.isfinite(d)] = np.nan
    span = float(np.nanmax(d, initial=0.0)) + 1.0
    d = d[np.argsort(np.repeat(np.arange(len(count)), count) + d / span)]
    lo, hi = bounds[:-1] + (count - 1) // 2, bounds[:-1] + count // 2
    live = count >= 16
    rough = np.full(len(count), np.nan)
    rough[live] = 0.5 * (d[lo[live]] + d[hi[live]]) * np.sqrt(count[live])
    if np.isnan(rough).all():
        return best
    top = np.nanmax(rough)
    best_score = -1.0
    for n in np.nonzero(rough >= top * (1.0 - 1e-5) - 1e-4)[0]:
        i, j = int(pairs[n, 0]), int(pairs[n, 1])
        sel = slice(bounds[n], bounds[n + 1])
        disp = np.median([np.linalg.norm(uv_of(i, a) - uv_of(j, b)) for a, b in
                          zip(tix.obs_feat[ra[sel]].tolist(), tix.obs_feat[rb[sel]].tolist())])
        score = disp * np.sqrt(count[n])
        if score > best_score:
            best_score, best = score, (i, j)
    return best


def run_sfm_from_matches(
    keypoints_uv: list[np.ndarray],
    pair_matches: dict[tuple[int, int], np.ndarray],
    intrinsics: np.ndarray,
    ba_iters: int = 25,
    min_track_len: int = 2,
    seed: int = 0,
    prune_px: float = 3.0,
    verify_pairs: bool = True,
    windowed_ba_every: int | None = None,
    poses_init: np.ndarray | None = None,
    registered_init: list[int] | None = None,
    device="cuda",
) -> SfmResult:
    """Incremental SfM from per-frame keypoint pixels + pairwise matches.

    keypoints_uv[i]: (N_i, 2) pixel coordinates of frame i's features.
    pair_matches[(i, j)]: (M, 2) int array of (feature_i, feature_j) pairs.
    intrinsics: (3, 3) K matrix (shared).

    ``poses_init``/``registered_init``: REFINE mode (the loop-closure flow):
    skip two-view init, triangulate every track from the given poses
    (re-using the incremental triangulator's partner selection and
    cheirality tests frame by frame), then register the frames left out
    and run the global Huber BA + prune from that initialization.

    The geometry and BA run on ``device`` (the card unless the caller asks
    for the CPU); the tracks and the registration order are host numpy.
    """
    dev = resolve_device(device)
    n_frames = len(keypoints_uv)
    k = np.asarray(intrinsics, np.float64)
    fxy = np.array([k[0, 0], k[1, 1]])
    cxy = np.array([k[0, 2], k[1, 2]])

    if verify_pairs:
        with profiling.span("sfm.verify"):
            pair_matches = _geometric_verify(keypoints_uv, pair_matches, k, seed, device=dev)

    def uv_of(f, feat):
        return keypoints_uv[f][feat]

    # ---- tracks ----
    with profiling.span("sfm.tracks"):
        # Tracks with two observations in the same frame are rejected
        # (ambiguous).
        tix = _TrackIndex(_track_groups(pair_matches, min_track_len), n_frames,
                          keypoints_uv=keypoints_uv)
        n_tracks = len(tix)
        profiling.count("sfm.tracks", n_tracks)

        # ---- choose the initialization pair ----
        # Among frame pairs sharing enough tracks, pick max median disparity
        # * sqrt(count): small-baseline pairs make the two-view geometry (and
        # the BA gauge, which freezes both init cameras) ill-conditioned.
        fa, fb = _init_pair(tix, uv_of)
    if poses_init is not None:
        # REFINE mode: rebuild the map from the given poses, frame by frame,
        # then FALL THROUGH to the incremental loop (frames the base run
        # failed to register get another chance with the richer track
        # graph) and the global BA.
        poses = np.asarray(poses_init, np.float64).copy()
        track_point = np.full(n_tracks, -1, np.int64)
        points: list[np.ndarray] = []
        registered = []
        for f in sorted(registered_init or range(n_frames)):
            registered.append(f)
            if len(registered) >= 2:
                with profiling.span("sfm.triangulate"):
                    _triangulate_new(f, tix, track_point, points, poses, registered,
                                     uv_of, k, device=dev)
    else:
        with profiling.span("sfm.init"):
            poses, registered, track_point, points = _initialize(tix, fa, fb, k, seed, dev)

    # ---- incremental registration ----
    # Register remaining frames most-constrained-first (greedy by current
    # 2D-3D candidate count).  Frames that fail (too few candidates or weak
    # PnP consensus) are RE-QUEUED and retried after others register: a
    # frame attempted before its neighbors exist in the map fails
    # permanently otherwise, and its own absence then starves ITS neighbors
    # of candidates.
    remaining = [f for f in range(n_frames) if f not in registered]
    retry = True
    while remaining and retry:
        retry = False
        deferred = []
        while remaining:
            with profiling.span("sfm.tracks"):
                counts = _candidate_counts(remaining, tix)
                f = max(remaining, key=lambda x: counts[x])
                remaining.remove(f)
            with profiling.span("sfm.register"):
                ok = _register_frame(f, tix, track_point, points, poses, registered, k, seed,
                                     device=dev)
            if not ok:
                deferred.append(f)
                continue
            retry = True
            with profiling.span("sfm.triangulate"):
                _triangulate_new(f, tix, track_point, points, poses, registered, uv_of, k,
                                 device=dev)
            if (windowed_ba_every and len(registered) % windowed_ba_every == 0
                    and len(points) >= 8):
                poses, points = _ba_pass(
                    n_frames, poses, points, tix, track_point, registered,
                    fa, fb, fxy, cxy, uv_of, max(ba_iters // 3, 5), device=dev,
                )
        remaining = deferred

    return _finish_global_ba(
        n_frames, poses, points, tix, track_point, registered,
        fa, fb, fxy, cxy, uv_of, ba_iters, prune_px, n_tracks, device=dev,
    )


def _initialize(tix, fa, fb, k, seed, dev):
    """Two-view initialization on frames ``fa``, ``fb`` from the tracks they
    share (in track order): essential-matrix RANSAC, pose recovery and
    triangulation.  Returns (poses, registered, track_point, points)."""
    n_frames = tix.n_frames
    init_ts = np.nonzero((tix.row[:, fa] >= 0) & (tix.row[:, fb] >= 0))[0]
    cap = max(64, 1 << int(np.ceil(np.log2(max(len(init_ts), 2)))))
    p1 = np.zeros((cap, 2))
    p2 = np.zeros((cap, 2))
    valid = np.zeros(cap, bool)
    init_track_ids = np.full(cap, -1, np.int64)
    n = len(init_ts)
    p1[:n] = _normalize(tix.obs_uv[tix.row[init_ts, fa]], k)
    p2[:n] = _normalize(tix.obs_uv[tix.row[init_ts, fb]], k)
    valid[:n] = True
    init_track_ids[:n] = init_ts

    p1_t, p2_t = _f32(p1, dev), _f32(p2, dev)
    profiling.count("sfm.ransac_lanes", RANSAC_HYPOTHESES * cap)
    e, inl, _ = ransac_essential(p1_t, p2_t, _mask(valid, dev), RANSAC_HYPOTHESES, 2e-3, seed)
    r2, t2, front = recover_pose(e, p1_t, p2_t, inl)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    x0 = triangulate(p1_t, p2_t, eye, torch.zeros(3, dtype=torch.float32, device=dev),
                     r2, t2)
    front = _host(front, "init")
    x0 = _host(x0, "init").astype(np.float64)

    poses = np.zeros((n_frames, 6))
    r2n = _host(r2, "init").astype(np.float64)
    cos = np.clip((np.trace(r2n) - 1) / 2, -1, 1)
    theta = np.arccos(cos)
    axis = np.array([r2n[2, 1] - r2n[1, 2], r2n[0, 2] - r2n[2, 0], r2n[1, 0] - r2n[0, 1]])
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    poses[fb, :3] = axis * theta
    poses[fb, 3:] = _host(t2, "init").astype(np.float64)

    track_point = np.full(len(tix), -1, np.int64)
    points = []
    for n in range(cap):
        if front[n] and init_track_ids[n] >= 0:
            track_point[init_track_ids[n]] = len(points)
            points.append(x0[n])
    tix.gained(np.nonzero(track_point >= 0)[0])
    return poses, [fa, fb], track_point, points


def _finish_global_ba(
    n_frames, poses, points, track_obs, track_point, registered,
    fa, fb, fxy, cxy, uv_of, ba_iters, prune_px, n_tracks, device="cuda",
) -> SfmResult:
    """Global Huber BA + reprojection-outlier prune + re-solve (the final
    stage of run_sfm_from_matches, shared with the refine-mode flow)."""
    dev = resolve_device(device)
    pts = np.asarray(points) if points else np.zeros((0, 3))
    with profiling.span("sfm.tracks"):
        obs_cam, obs_pt, obs_uv = _observations(track_obs, track_point, registered)

    info = {"n_tracks": n_tracks, "n_points": len(pts), "n_obs": len(obs_cam),
            "registered": sorted(registered)}
    if len(obs_cam) >= 12 and len(pts) >= 8:
        fixed = np.zeros(n_frames, bool)
        fixed[fa] = True
        fixed[fb] = True  # freezes gauge incl. scale
        pr = _problem(poses, pts, obs_cam, obs_pt, obs_uv, fixed, fxy, cxy, dev)
        # Huber delta = the prune threshold: outliers beyond it get
        # linear weight instead of dragging the L2 solve into a wrong
        # minimum.
        with profiling.span("sfm.ba"):
            cams_opt, pts_opt, ba_info = ba_solve(pr, ba_iters, huber_delta=float(prune_px))

        # Outlier pruning + re-BA: mask observations whose reprojection error
        # after the first solve exceeds ``prune_px``, then re-optimize.
        r_obs, _ = _residuals(pr, cams_opt, pts_opt)
        keep = _host(torch.linalg.vector_norm(r_obs, dim=-1), "prune") < prune_px
        info["pruned_obs"] = int((~keep).sum())
        if 0 < info["pruned_obs"] < 0.5 * len(keep):
            pr = dataclasses.replace(pr, cams=cams_opt, points=pts_opt,
                                     obs_mask=_mask(keep, dev))
            with profiling.span("sfm.ba"):
                cams_opt, pts_opt, ba_info2 = ba_solve(pr, max(ba_iters // 2, 5),
                                                       huber_delta=float(prune_px))
            info["ba_reprune"] = ba_info2

        poses = _host(cams_opt, "ba").astype(np.float64)
        pts = _host(pts_opt, "ba").astype(np.float64)
        info["ba"] = ba_info

    return SfmResult(poses=poses, points=pts, track_point=track_point, info=info)


def loop_closure_candidates(
    descs: list[np.ndarray],
    min_gap: int,
    top_k: int = 2,
    min_sim: float = 0.85,
) -> list[tuple[int, int]]:
    """Retrieval-based loop-closure candidate pairs.

    Global frame descriptor = L2-normalized mean of the frame's unit SIFT
    descriptors, centred across the corpus (SIFT descriptors are
    non-negative, so raw frame means share a large DC component); frames
    more than ``min_gap`` apart whose cosine similarity clears ``min_sim``
    become candidates (``top_k`` best per frame).
    """
    gd = []
    for d in descs:
        if len(d) == 0:
            gd.append(np.zeros(128, np.float32))
            continue
        dn = d.astype(np.float32)
        dn /= np.maximum(np.linalg.norm(dn, axis=1, keepdims=True), 1e-6)
        m = dn.mean(0)
        gd.append(m / max(float(np.linalg.norm(m)), 1e-6))
    g = np.stack(gd)
    g = g - g.mean(0, keepdims=True)
    g /= np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-6)
    sim = g @ g.T
    out = []
    n = len(descs)
    for i in range(n):
        order = np.argsort(-sim[i])
        picked = 0
        for j in order:
            j = int(j)
            if j < i + min_gap or sim[i, j] < min_sim:
                continue
            out.append((i, j))
            picked += 1
            if picked >= top_k:
                break
    return sorted(set(out))


def run_sfm(images, intrinsics, cfg: SiftConfig | None = None, ba_iters: int = 25,
            match_window: int = 2, loop_closure: bool = True, device="cuda") -> SfmResult:
    """Full SfM on an image sequence: detection + matching + incremental SfM,
    on the card unless ``device="cpu"``.

    Each frame is detected alone (``detect_and_describe_batch`` at batch 1
    with ``return_counts``); ``info["counts"]`` holds every frame's counts
    in the entry point's layout (a batch of all the frames), which
    ``models/sift.clipped`` reads.

    Matching covers a temporal window (i, i+k) for k <= ``match_window``:
    on dense sequences adjacent baselines are tiny, and skip pairs add
    wide-baseline constraints and merge tracks across the window.

    ``loop_closure`` (default ON): a GATED REPAIR pass.  Retrieval-proposed
    revisit pairs (loop_closure_candidates), pose-prior-gated, become (1)
    pose-graph constraints, relaxed by pose_graph_relax, and (2) cross-pass
    track merges in a re-triangulated second solve that also registers the
    frames the base run missed (with motion-prior pose fill where PnP is
    ill-conditioned).  The repair runs only on observable base-solve
    distress (coverage holes, heavy pruning, closure gaps above the noise
    floor); a healthy loop is returned untouched
    (``info["loop_closure_skipped"]``).
    """
    with profiling.span("sfm.run"):
        out, counts = _run_sfm(images, intrinsics, cfg or SiftConfig(), ba_iters, match_window,
                               loop_closure, resolve_device(device))
    out.info["counts"] = counts
    profiling.count("sfm.registered", len(out.info.get("registered", [])))
    return out


def _run_sfm(images, intrinsics, cfg, ba_iters, match_window, loop_closure, dev):
    """``run_sfm``'s body: (result, counts)."""
    with profiling.span("sfm.detect"):
        kps, per_frame = [], []
        for img in images:
            img = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img)
            kp, c = detect_and_describe_batch(img[None], cfg, return_counts=True, device=dev)
            kps.append(kp.map(lambda a: a[0]))
            per_frame.append(c)
        counts = {name: torch.cat([c[name].reshape(1, *c[name].shape[1:]) for c in per_frame])
                  for name in per_frame[0]} if per_frame else {}
        uvs = [_host(torch.stack([kp.x, kp.y], -1), "keypoints") for kp in kps]

    def match_pair(i, j):
        with profiling.span("sfm.match"):
            idx, acc, _, _ = match_descriptors(kps[i].desc, kps[i].valid, kps[j].desc,
                                               kps[j].valid, cfg.ratio_threshold, device=dev)
            acc = _host(acc, "matches")
            idx = _host(idx, "matches")
        rows = np.nonzero(acc)[0]
        return np.stack([rows, idx[rows]], axis=-1)

    pair_matches = {}
    for i in range(len(images) - 1):
        for j in range(i + 1, min(i + 1 + match_window, len(images))):
            pair_matches[(i, j)] = match_pair(i, j)

    base = run_sfm_from_matches(uvs, dict(pair_matches), intrinsics, ba_iters, device=dev)
    if not (loop_closure and len(images) > 2 * (match_window + 1)):
        return base, counts
    with profiling.span("sfm.loop_closure"):
        return _loop_closure(base, kps, uvs, pair_matches, match_pair, intrinsics, ba_iters,
                             match_window, len(images), dev), counts


def _loop_closure(base, kps, uvs, pair_matches, match_pair, intrinsics, ba_iters,
                  match_window, n_images, dev) -> SfmResult:
    """``run_sfm``'s gated loop-closure repair of the base solve ``base``."""
    # Pose-prior-gated loop closure: a candidate is accepted only when its
    # two estimated camera centers are already near each other relative to
    # the trajectory length (retrieval alone cannot tell a revisit from
    # perceptual aliasing: periodic texture displaced by whole periods).
    reg = base.info.get("registered", list(range(n_images)))
    rmats = _host(rodrigues(_f32(base.poses[:, :3], dev)), "rotation")
    centers = -np.einsum("nij,nj->ni", rmats.transpose(0, 2, 1), base.poses[:, 3:])
    reg_sorted = sorted(reg)
    path = float(sum(np.linalg.norm(centers[b] - centers[a])
                     for a, b in zip(reg_sorted, reg_sorted[1:])))
    if path <= 0:
        return base
    descs = [_host(kp.desc[kp.valid], "descriptors") for kp in kps]
    reg_set = set(reg)
    closures = []
    deferred = []
    accepted = []
    gaps = []
    min_gap = max(8, 4 * match_window)
    for (i, j) in loop_closure_candidates(descs, min_gap, min_sim=0.95):
        if (i, j) in pair_matches:
            continue
        if i not in reg_set or j not in reg_set:
            # No pose prior to gate on: accepted below only by temporal
            # coherence with a pose-gated neighbor pair.
            deferred.append((i, j))
            continue
        # Upper bound 0.1 * path (aliasing guard); no lower bound.
        gap = float(np.linalg.norm(centers[i] - centers[j]))
        if gap > 0.1 * path:
            continue
        m = match_pair(i, j)
        if len(m) < 24:  # enough support for a reliable rotation estimate
            continue
        q1 = _normalize(uvs[i][m[:, 0]], np.asarray(intrinsics, np.float64))
        q2 = _normalize(uvs[j][m[:, 1]], np.asarray(intrinsics, np.float64))
        closures.append((i, j, _relative_rotation(q1, q2)))
        pair_matches[(i, j)] = m
        accepted.append((i, j))
        gaps.append(gap)
    for (i, j) in deferred:
        if any(abs(i - a) <= 3 and abs(j - b) <= 3 for a, b in accepted):
            m = match_pair(i, j)
            if len(m) >= 24:
                pair_matches[(i, j)] = m
    if not closures:
        return base

    # DRIFT GATE: repair only on observable distress in the window-only
    # solve: coverage holes, heavy outlier pruning, or closure-pair center
    # gaps materially above the noise floor.
    distressed = (
        len(reg) < n_images
        or base.info.get("pruned_obs", 0) > 0.02 * max(base.info.get("n_obs", 1), 1)
        or float(np.median(gaps)) > 0.02 * path
    )
    if not distressed:
        base.info["loop_closure_skipped"] = "base solve healthy"
        return base

    # Closure pairs serve as pose-graph constraints (relaxed before the
    # second pass) and as track merges; the second pass re-verifies every
    # pair, triangulates from the relaxed poses, registers the frames the
    # base run missed, and runs the Huber BA + prune.
    profiling.count("sfm.loop_repairs", 1)
    poses_pgo = pose_graph_relax(base.poses, reg, closures)
    poses_pgo, filled = _fill_unregistered_by_interpolation(
        poses_pgo, sorted(reg), n_images, max_dist=8, device=dev)
    out = run_sfm_from_matches(uvs, pair_matches, intrinsics, ba_iters,
                               poses_init=poses_pgo,
                               registered_init=sorted(set(reg) | set(filled)), device=dev)
    out.info["loop_pairs_added"] = len(closures)
    # Safety net: if the closure-merged pass registered FEWER frames than
    # the window-only base (a poisoned track graph), fall back.
    if len(out.info.get("registered", [])) < len(reg):
        return base
    return out
