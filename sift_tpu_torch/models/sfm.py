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
"""

from __future__ import annotations

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
from sift_tpu_torch.models.geometry import (
    _sampson_err2,
    mat_vecs,
    matmul3,
    ransac_essential,
    ransac_pnp,
    recover_pose,
    rodrigues,
    triangulate,
)
from sift_tpu_torch.models.match import match_descriptors
from sift_tpu_torch.models.sift import detect_and_describe
from sift_tpu_torch.models.stitch import _apply_h, ransac_homography
from sift_tpu_torch.utils.numerics import resolve_device


@dataclasses.dataclass
class SfmResult:
    poses: np.ndarray        # (C, 6) [rvec, tvec], x_cam = R X + t
    points: np.ndarray       # (P, 3)
    track_point: np.ndarray  # (T,) index into points or -1
    info: dict


class _Tracks:
    """Union-find feature tracks over (frame, feature) observations."""

    def __init__(self):
        self.parent: dict[tuple[int, int], tuple[int, int]] = {}

    def find(self, k):
        p = self.parent.setdefault(k, k)
        if p != k:
            r = self.find(p)
            self.parent[k] = r
            return r
        return k

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb

    def groups(self):
        out: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for k in list(self.parent):
            out.setdefault(self.find(k), []).append(k)
        return list(out.values())


def _normalize(uv: np.ndarray, k: np.ndarray) -> np.ndarray:
    return (uv - k[[0, 1], [2, 2]]) / k[[0, 1], [0, 1]]


def _f32(a, dev) -> torch.Tensor:
    """Host numbers -> float32 on ``dev``, rounded to nearest (``jnp.asarray
    (a, jnp.float32)``)."""
    return torch.as_tensor(np.asarray(a), device=dev).to(torch.float32)


def _rot(rvecs, dev) -> np.ndarray:
    """Rotation matrices of (..., 3) rotation vectors: ``rodrigues`` in
    float32 on ``dev``, returned as float64 numpy."""
    return rodrigues(_f32(rvecs, dev)).cpu().numpy().astype(np.float64)


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
    """
    dev = resolve_device(device)
    f_mean = float(np.sqrt(k[0, 0] * k[1, 1]))
    sig2 = sigma_px * sigma_px
    lam1 = float(np.log(4.0))
    out = {}
    for (i, j), m in pair_matches.items():
        if len(m) < 16:
            out[(i, j)] = m
            continue
        p1 = keypoints_uv[i][m[:, 0]]
        p2 = keypoints_uv[j][m[:, 1]]
        n_m = len(m)
        cap = max(64, 1 << int(np.ceil(np.log2(n_m))))
        q1 = np.zeros((cap, 2))
        q2 = np.zeros((cap, 2))
        v = np.zeros(cap, bool)
        q1[:n_m] = _normalize(p1, k)
        q2[:n_m] = _normalize(p2, k)
        v[:n_m] = True
        u1 = np.zeros((cap, 2))
        u2 = np.zeros((cap, 2))
        u1[:n_m] = p1
        u2[:n_m] = p2
        v_t = torch.as_tensor(v, device=dev)

        # Homography hypothesis (pixel space, 2 px inlier threshold).
        u1_t = _f32(u1, dev)
        h_px, h_inl, _ = ransac_homography(u1_t, _f32(u2, dev), v_t, 1024, 2.0 * sigma_px,
                                           seed + 7 * i + j)
        proj = _apply_h(h_px, u1_t).cpu().numpy()
        err2_h = ((proj[:n_m] - u2[:n_m]) ** 2).sum(1)
        # Keep band: 2 sigma, decoupled from the RANSAC fit bands (the JAX
        # package's calibration on its rendered evaluation).
        keep2 = (keep_sigma * sigma_px) ** 2

        disp = np.median(np.linalg.norm(p2 - p1, axis=1))
        if disp < 1.5:
            # Revisited / static viewpoint: E is degenerate by construction,
            # H is the exact model: skip the E fit and its GRIC.
            keep = err2_h < keep2
            if int(keep.sum()) >= min_inl:
                out[(i, j)] = m[keep]
            continue

        q1_t, q2_t = _f32(q1, dev), _f32(q2, dev)
        e, e_inl, _ = ransac_essential(q1_t, q2_t, v_t, 1024, thr, seed + 7 * i + j)
        # Sampson distance in normalized units -> px^2 via the mean focal.
        err2_e = _sampson_err2(e[None], q1_t, q2_t).cpu().numpy()[0][:n_m] * (f_mean * f_mean)

        lam2 = float(np.log(4.0 * n_m))
        gric_e = (np.minimum(err2_e / sig2, 2.0 * (4 - 3)).sum()
                  + lam1 * 3 * n_m + lam2 * 5)
        gric_h = (np.minimum(err2_h / sig2, 2.0 * (4 - 2)).sum()
                  + lam1 * 2 * n_m + lam2 * 8)
        if stats is not None:
            stats[(i, j)] = dict(
                model=("H" if gric_h < gric_e else "E"),
                gric_e=float(gric_e), gric_h=float(gric_h), n=n_m,
                e_inl=int(e_inl.cpu().numpy()[:n_m].sum()),
                h_inl=int(h_inl.cpu().numpy()[:n_m].sum()),
            )
        # The UNION of both models' keep bands: each model has structure
        # the other cannot represent (H: off-plane parallax; E: planar or
        # rotation-dominant sets); a repeated-texture confusion sits far
        # outside both.
        keep = (err2_e < keep2) | (err2_h < keep2)
        if int(keep.sum()) >= min_inl:
            out[(i, j)] = m[keep]
        # else: drop the pair entirely (no consistent geometry)
    return out


def _observations(track_obs, track_point, registered, uv_of):
    """The (cam, point, uv) rows of every triangulated track in the
    registered frames."""
    obs_cam, obs_pt, obs_uv = [], [], []
    reg = set(registered)
    for t, g in enumerate(track_obs):
        pid = track_point[t]
        if pid < 0:
            continue
        for f, feat in g:
            if f in reg:
                obs_cam.append(f)
                obs_pt.append(pid)
                obs_uv.append(uv_of(f, feat))
    return (np.asarray(obs_cam, np.int32), np.asarray(obs_pt, np.int32),
            np.asarray(obs_uv, np.float64).reshape(-1, 2))


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
    """
    pts = np.asarray(points)
    obs_cam, obs_pt, obs_uv = _observations(track_obs, track_point, registered, uv_of)
    if len(obs_cam) < 12 or len(pts) < 8:
        return poses, points
    fixed = np.ones(n_frames, bool)  # unregistered cams must not move
    for f in registered:
        fixed[f] = False
    fixed[fa] = True
    fixed[fb] = True  # freezes gauge incl. scale
    pr = _problem(poses, pts, obs_cam, obs_pt, obs_uv, fixed, fxy, cxy, resolve_device(device))
    cams_opt, pts_opt, _ = ba_solve(pr, iters, huber_delta=3.0)
    return (cams_opt.cpu().numpy().astype(np.float64),
            list(pts_opt.cpu().numpy().astype(np.float64)))


def _register_frame(
    f, track_obs, track_point, points, poses, registered, uv_of, k, seed, device="cuda",
) -> bool:
    """PnP-register frame ``f`` against the current map (consensus-gated).

    Returns False (leaving ``poses``/``registered`` untouched) when the
    frame has too few 2D-3D candidates or a weak consensus: callers
    re-queue it and retry after more neighbors register.
    """
    dev = resolve_device(device)
    cands = []
    for t, g in enumerate(track_obs):
        gd = dict(g)
        if f in gd and track_point[t] >= 0:
            cands.append((t, gd[f]))
    if len(cands) < 8:
        return False
    cap_f = max(64, 1 << int(np.ceil(np.log2(len(cands)))))
    x3 = np.zeros((cap_f, 3))
    x2 = np.zeros((cap_f, 2))
    v = np.zeros(cap_f, bool)
    for n, (t, feat) in enumerate(cands[:cap_f]):
        x3[n] = points[track_point[t]]
        x2[n] = _normalize(uv_of(f, feat), k)
        v[n] = True
    rvec, tvec, _, cnt = ransac_pnp(_f32(x3, dev), _f32(x2, dev), torch.as_tensor(v, device=dev),
                                    1024, 8e-3, seed + f)
    # Gate on PnP consensus: a frame with essentially no inliers would
    # seed triangulation and BA with a garbage pose.
    n_cand = int(np.count_nonzero(v))
    if int(cnt) < max(6, n_cand // 10):
        return False
    poses[f, :3] = rvec.cpu().numpy().astype(np.float64)
    poses[f, 3:] = tvec.cpu().numpy().astype(np.float64)
    registered.append(f)
    return True


def _triangulate_new(
    f, track_obs, track_point, points, poses, registered, uv_of, k, device="cuda",
) -> None:
    """Triangulate tracks newly observable from freshly-registered ``f``.

    Partner = the max-disparity registered frame, skipping near-zero
    baselines (a revisited viewpoint pairs almost-identical frames;
    triangulating them puts garbage points at quasi-infinite depth that
    survive cheirality).  The 0.75 px floor only skips near-identical
    viewpoints.  All of the frame's new tracks are triangulated in one
    batch on ``device`` (each row its own partner pose).
    """
    dev = resolve_device(device)
    new = []
    for t, g in enumerate(track_obs):
        gd = dict(g)
        if track_point[t] < 0 and f in gd:
            best_pf, best_d = -1, 0.0
            for rf in registered[:-1]:
                if rf not in gd:
                    continue
                d = float(np.linalg.norm(uv_of(rf, gd[rf]) - uv_of(f, gd[f])))
                if d > best_d:
                    best_pf, best_d = rf, d
            if best_pf >= 0 and best_d >= 0.75:
                new.append((t, best_pf, gd[best_pf], gd[f]))
    if not new:
        return
    q1 = np.stack([_normalize(uv_of(pf, fp), k) for _, pf, fp, _ in new])
    q2 = np.stack([_normalize(uv_of(f, ff), k) for _, _, _, ff in new])
    pfs = [pf for _, pf, _, _ in new]
    rots = _rot(np.concatenate([poses[pfs, :3], poses[f:f + 1, :3]]), dev)
    r1s, rf = rots[:-1], rots[-1]
    t1s = poses[pfs, 3:]
    xn = triangulate(_f32(q1, dev), _f32(q2, dev), _f32(r1s, dev), _f32(t1s, dev),
                     _f32(rf, dev), _f32(poses[f, 3:], dev)).cpu().numpy().astype(np.float64)
    for n, (t, _, _, _) in enumerate(new):
        # Cheirality in both views.
        xc1 = r1s[n] @ xn[n] + t1s[n]
        xc2 = rf @ xn[n] + poses[f, 3:]
        if xc1[2] > 0.05 and xc2[2] > 0.05 and np.isfinite(xn[n]).all():
            track_point[t] = len(points)
            points.append(xn[n])


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


def _candidate_counts(remaining, track_obs, track_point) -> dict[int, int]:
    """Each remaining frame's current count of 2D-3D candidates: a pass over
    every track for every frame, as in the JAX package."""
    return {f: sum(1 for t, g in enumerate(track_obs) if track_point[t] >= 0 and f in dict(g))
            for f in remaining}


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
        pair_matches = _geometric_verify(keypoints_uv, pair_matches, k, seed, device=dev)

    # ---- tracks ----
    tr = _Tracks()
    for (i, j), m in pair_matches.items():
        for a, b in m:
            tr.union((i, int(a)), (j, int(b)))
    groups = [g for g in tr.groups() if len(g) >= min_track_len]
    # Reject tracks with two observations in the same frame (ambiguous).
    groups = [g for g in groups if len({f for f, _ in g}) == len(g)]
    track_obs = [sorted(g) for g in groups]
    n_tracks = len(track_obs)

    def uv_of(f, feat):
        return keypoints_uv[f][feat]

    # ---- choose the initialization pair ----
    # Among frame pairs sharing enough tracks, pick max median disparity *
    # sqrt(count): small-baseline pairs make the two-view geometry (and the
    # BA gauge, which freezes both init cameras) ill-conditioned.
    shared: dict[tuple[int, int], list] = {}
    for t, g in enumerate(track_obs):
        gd = dict(g)
        fs = sorted(gd)
        for ai in range(len(fs)):
            for bi in range(ai + 1, len(fs)):
                shared.setdefault((fs[ai], fs[bi]), []).append((t, gd))
    best_score = -1.0
    fa, fb = 0, min(1, n_frames - 1)
    for (i, j), lst in shared.items():
        if len(lst) < 16:
            continue
        disp = np.median([np.linalg.norm(uv_of(i, gd[i]) - uv_of(j, gd[j])) for t, gd in lst])
        score = disp * np.sqrt(len(lst))
        if score > best_score:
            best_score = score
            fa, fb = i, j
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
                _triangulate_new(f, track_obs, track_point, points, poses, registered,
                                 uv_of, k, device=dev)
    else:
        init_pairs = shared.get((fa, fb), [
            (t, dict(g)) for t, g in enumerate(track_obs)
            if fa in dict(g) and fb in dict(g)
        ])
        cap = max(64, 1 << int(np.ceil(np.log2(max(len(init_pairs), 2)))))
        p1 = np.zeros((cap, 2))
        p2 = np.zeros((cap, 2))
        valid = np.zeros(cap, bool)
        init_track_ids = np.full(cap, -1, np.int64)
        for n, (t, g) in enumerate(init_pairs[:cap]):
            p1[n] = _normalize(uv_of(fa, g[fa]), k)
            p2[n] = _normalize(uv_of(fb, g[fb]), k)
            valid[n] = True
            init_track_ids[n] = t

        p1_t, p2_t = _f32(p1, dev), _f32(p2, dev)
        e, inl, _ = ransac_essential(p1_t, p2_t, torch.as_tensor(valid, device=dev),
                                     1024, 2e-3, seed)
        r2, t2, front = recover_pose(e, p1_t, p2_t, inl)
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        x0 = triangulate(p1_t, p2_t, eye, torch.zeros(3, dtype=torch.float32, device=dev),
                         r2, t2)
        front = front.cpu().numpy()
        x0 = x0.cpu().numpy().astype(np.float64)

        poses = np.zeros((n_frames, 6))
        registered = [fa, fb]
        r2n = r2.cpu().numpy().astype(np.float64)
        cos = np.clip((np.trace(r2n) - 1) / 2, -1, 1)
        theta = np.arccos(cos)
        axis = np.array([r2n[2, 1] - r2n[1, 2], r2n[0, 2] - r2n[2, 0], r2n[1, 0] - r2n[0, 1]])
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        poses[fb, :3] = axis * theta
        poses[fb, 3:] = t2.cpu().numpy().astype(np.float64)

        track_point = np.full(n_tracks, -1, np.int64)
        points = []
        for n in range(cap):
            if front[n] and init_track_ids[n] >= 0:
                track_point[init_track_ids[n]] = len(points)
                points.append(x0[n])

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
            counts = _candidate_counts(remaining, track_obs, track_point)
            f = max(remaining, key=lambda x: counts[x])
            remaining.remove(f)
            if not _register_frame(f, track_obs, track_point, points, poses, registered,
                                   uv_of, k, seed, device=dev):
                deferred.append(f)
                continue
            retry = True
            _triangulate_new(f, track_obs, track_point, points, poses, registered, uv_of, k,
                             device=dev)
            if (windowed_ba_every and len(registered) % windowed_ba_every == 0
                    and len(points) >= 8):
                poses, points = _ba_pass(
                    n_frames, poses, points, track_obs, track_point, registered,
                    fa, fb, fxy, cxy, uv_of, max(ba_iters // 3, 5), device=dev,
                )
        remaining = deferred

    return _finish_global_ba(
        n_frames, poses, points, track_obs, track_point, registered,
        fa, fb, fxy, cxy, uv_of, ba_iters, prune_px, n_tracks, device=dev,
    )


def _finish_global_ba(
    n_frames, poses, points, track_obs, track_point, registered,
    fa, fb, fxy, cxy, uv_of, ba_iters, prune_px, n_tracks, device="cuda",
) -> SfmResult:
    """Global Huber BA + reprojection-outlier prune + re-solve (the final
    stage of run_sfm_from_matches, shared with the refine-mode flow)."""
    dev = resolve_device(device)
    pts = np.asarray(points) if points else np.zeros((0, 3))
    obs_cam, obs_pt, obs_uv = _observations(track_obs, track_point, registered, uv_of)

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
        cams_opt, pts_opt, ba_info = ba_solve(pr, ba_iters, huber_delta=float(prune_px))

        # Outlier pruning + re-BA: mask observations whose reprojection error
        # after the first solve exceeds ``prune_px``, then re-optimize.
        r_obs, _ = _residuals(pr, cams_opt, pts_opt)
        keep = torch.linalg.vector_norm(r_obs, dim=-1).cpu().numpy() < prune_px
        info["pruned_obs"] = int((~keep).sum())
        if 0 < info["pruned_obs"] < 0.5 * len(keep):
            pr = dataclasses.replace(pr, cams=cams_opt, points=pts_opt,
                                     obs_mask=torch.as_tensor(keep, device=dev))
            cams_opt, pts_opt, ba_info2 = ba_solve(pr, max(ba_iters // 2, 5),
                                                   huber_delta=float(prune_px))
            info["ba_reprune"] = ba_info2

        poses = cams_opt.cpu().numpy().astype(np.float64)
        pts = pts_opt.cpu().numpy().astype(np.float64)
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
    dev = resolve_device(device)
    cfg = cfg or SiftConfig()
    kps = [detect_and_describe(img, cfg, device=dev) for img in images]
    uvs = [torch.stack([kp.x, kp.y], -1).cpu().numpy() for kp in kps]

    def match_pair(i, j):
        idx, acc, _, _ = match_descriptors(kps[i].desc, kps[i].valid, kps[j].desc,
                                           kps[j].valid, cfg.ratio_threshold, device=dev)
        acc = acc.cpu().numpy()
        idx = idx.cpu().numpy()
        rows = np.nonzero(acc)[0]
        return np.stack([rows, idx[rows]], axis=-1)

    pair_matches = {}
    for i in range(len(images) - 1):
        for j in range(i + 1, min(i + 1 + match_window, len(images))):
            pair_matches[(i, j)] = match_pair(i, j)

    base = run_sfm_from_matches(uvs, dict(pair_matches), intrinsics, ba_iters, device=dev)
    if not (loop_closure and len(images) > 2 * (match_window + 1)):
        return base

    # Pose-prior-gated loop closure: a candidate is accepted only when its
    # two estimated camera centers are already near each other relative to
    # the trajectory length (retrieval alone cannot tell a revisit from
    # perceptual aliasing: periodic texture displaced by whole periods).
    reg = base.info.get("registered", list(range(len(images))))
    rmats = rodrigues(_f32(base.poses[:, :3], dev)).cpu().numpy()
    centers = -np.einsum("nij,nj->ni", rmats.transpose(0, 2, 1), base.poses[:, 3:])
    reg_sorted = sorted(reg)
    path = float(sum(np.linalg.norm(centers[b] - centers[a])
                     for a, b in zip(reg_sorted, reg_sorted[1:])))
    if path <= 0:
        return base
    descs = [kp.desc[kp.valid].cpu().numpy() for kp in kps]
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
        len(reg) < len(images)
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
    poses_pgo = pose_graph_relax(base.poses, reg, closures)
    poses_pgo, filled = _fill_unregistered_by_interpolation(
        poses_pgo, sorted(reg), len(images), max_dist=8, device=dev)
    out = run_sfm_from_matches(uvs, pair_matches, intrinsics, ba_iters,
                               poses_init=poses_pgo,
                               registered_init=sorted(set(reg) | set(filled)), device=dev)
    out.info["loop_pairs_added"] = len(closures)
    # Safety net: if the closure-merged pass registered FEWER frames than
    # the window-only base (a poisoned track graph), fall back.
    if len(out.info.get("registered", [])) < len(reg):
        return base
    return out
