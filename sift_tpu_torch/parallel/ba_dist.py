"""Distributed bundle adjustment: point-sharded Schur reduction.

Counterpart of ``sift_tpu/parallel/ba_dist.py``.  The normal-equation
assembly (``models/ba._schur_parts``) is a reduction over points and their
observations, so it shards cleanly: each ``kp`` rank owns a slice of the
points and their observations and computes its partial camera blocks U,
gradient g_c and Schur sums with ``models/ba``'s fixed-order forms (the
camera-membership GEMMs and the ``obs_by_point`` table, no scatter-add);
the partials and the cost are summed over ``kp`` with one ``all_reduce``.
The reduced (6C, 6C) camera solve is small and runs on every rank; point
back-substitution is local to each shard, and the updated points are
gathered so that every rank returns the whole problem.  No Huber loss, as
in the JAX step.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from sift_tpu_torch.models import ba as B
from sift_tpu_torch.models.ba import BAProblem, build_obs_by_point
from sift_tpu_torch.parallel.mesh import all_gather, all_reduce, axis_index, axis_size, mesh_device
from sift_tpu_torch.utils.numerics import resolve_device


def shard_ba_problem(cams, points, obs_cam, obs_pt, obs_uv, n_shards: int, fxy, cxy,
                     fixed_cams, dtype=torch.float32, device="cuda"):
    """Host-side prep: round-robin points over shards, group each point's
    observations into its shard, pad all shards to equal sizes.

    Returns (dict of tensors on ``device`` with a leading shard axis on the
    point / observation arrays, (shard_of, local_idx)), where
    points[global] lives at (shard_of[g], local_idx[g]).  The arrays are
    the JAX package's, value for value (indices as int64, as
    ``models/ba.BAProblem`` takes them).
    """
    dev = resolve_device(device)
    points = np.asarray(points)
    obs_pt = np.asarray(obs_pt)
    p_total = len(points)
    shard_of = np.arange(p_total) % n_shards
    local_idx = np.zeros(p_total, np.int64)
    p_max = 0
    for s in range(n_shards):
        ids = np.nonzero(shard_of == s)[0]
        local_idx[ids] = np.arange(len(ids))
        p_max = max(p_max, len(ids))
    p_max = max(p_max, 1)

    obs_shard = shard_of[obs_pt]
    o_max = max(int(np.bincount(obs_shard, minlength=n_shards).max()), 1)

    s_points = np.zeros((n_shards, p_max, 3), np.float64)
    s_pmask = np.zeros((n_shards, p_max), bool)
    s_obs_cam = np.zeros((n_shards, o_max), np.int64)
    s_obs_pt = np.zeros((n_shards, o_max), np.int64)
    s_obs_uv = np.zeros((n_shards, o_max, 2), np.float64)
    s_obs_mask = np.zeros((n_shards, o_max), bool)
    tbls = []
    f_max = 1
    for s in range(n_shards):
        pids = np.nonzero(shard_of == s)[0]
        s_points[s, : len(pids)] = points[pids]
        s_pmask[s, : len(pids)] = True
        oids = np.nonzero(obs_shard == s)[0]
        s_obs_cam[s, : len(oids)] = np.asarray(obs_cam)[oids]
        s_obs_pt[s, : len(oids)] = local_idx[obs_pt[oids]]
        s_obs_uv[s, : len(oids)] = np.asarray(obs_uv)[oids]
        s_obs_mask[s, : len(oids)] = True
        tbl = build_obs_by_point(s_obs_pt[s, : len(oids)], p_max)
        tbls.append(tbl)
        f_max = max(f_max, tbl.shape[1])
    s_tbl = np.full((n_shards, p_max, f_max), -1, np.int64)
    for s, tbl in enumerate(tbls):
        s_tbl[s, :, : tbl.shape[1]] = tbl

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dtype)

    def t(a):
        return torch.as_tensor(a, device=dev)

    sp = dict(
        cams=f(cams), points=f(s_points), pmask=t(s_pmask), obs_cam=t(s_obs_cam),
        obs_pt=t(s_obs_pt), obs_uv=f(s_obs_uv), obs_mask=t(s_obs_mask),
        obs_by_point=t(s_tbl), fxy=f(fxy), cxy=f(cxy),
        fixed_cams=t(np.asarray(fixed_cams, bool)),
    )
    return sp, (shard_of, local_idx)


def _local(sp: dict, mesh: DeviceMesh):
    """This rank's shard of ``sp`` as a ``BAProblem`` on the mesh's device,
    and its point mask."""
    nkp, s = axis_size(mesh, "kp"), axis_index(mesh, "kp")
    if sp["points"].shape[0] != nkp:
        raise ValueError(f"problem has {sp['points'].shape[0]} shards, the kp axis {nkp}")
    dev = mesh_device(mesh)

    def get(k):
        a = sp[k] if k in ("cams", "fxy", "cxy", "fixed_cams") else sp[k][s]
        return a.to(dev)

    pr = BAProblem(cams=get("cams"), points=get("points"), obs_cam=get("obs_cam"),
                   obs_pt=get("obs_pt"), obs_uv=get("obs_uv"), obs_mask=get("obs_mask"),
                   obs_by_point=get("obs_by_point"), fxy=get("fxy"), cxy=get("cxy"),
                   fixed_cams=get("fixed_cams"))
    return pr, get("pmask")


def sharded_ba_step(sp: dict, lam: float, mesh: DeviceMesh):
    """One LM step; returns (new_cams, new_points (n_shards, P, 3), the
    cost before the step), the same on every rank."""
    pr, pmask = _local(sp, mesh)
    lam_t = torch.tensor(lam, dtype=pr.cams.dtype, device=pr.cams.device)
    r, jc, jp = B._jacobians(pr, pr.cams, pr.points)
    u, g_c, yw, yg, v_inv, w, cam_of, g_p = B._schur_parts(pr, jc, jp, r, lam_t)
    parts = [(r * r).sum().reshape(1), u, g_c, yw, yg]
    sums = all_reduce(torch.cat([p.reshape(-1) for p in parts]), mesh, "kp")
    cost, u, g_c, yw, yg = (a.reshape(p.shape) for a, p in zip(
        torch.split(sums, [p.numel() for p in parts]), parts))
    s, rhs = B._schur_combine(u, g_c, yw, yg, lam_t)
    delta_c = B._solve_cameras(s, rhs, pr.fixed_cams)
    delta_p = B._back_substitute(v_inv, w, cam_of, g_p, delta_c) * pmask[:, None].to(u.dtype)
    return pr.cams + delta_c, all_gather(pr.points + delta_p, mesh, "kp"), cost[0]


def sharded_cost(sp: dict, mesh: DeviceMesh):
    """Total reprojection cost of a sharded problem (0-dim tensor), the same
    on every rank."""
    pr, _ = _local(sp, mesh)
    r, _ = B._residuals(pr, pr.cams, pr.points)
    return all_reduce((r * r).sum(), mesh, "kp")


def sharded_ba_solve(sp: dict, mesh: DeviceMesh, iters: int = 15, lam0: float = 1e-3):
    """LM loop around ``sharded_ba_step`` (host-controlled damping
    schedule, one read of the cost per iteration); returns (the problem with
    the solved cameras and points, info dict with the cost trace)."""
    lam = lam0
    cost = float(sharded_cost(sp, mesh))
    trace = [cost]
    for _ in range(iters):
        cams_new, pts_new, _ = sharded_ba_step(sp, lam, mesh)
        cand = dict(sp, cams=cams_new, points=pts_new)
        new_cost = float(sharded_cost(cand, mesh))
        if new_cost < cost and np.isfinite(new_cost):
            sp = cand
            cost = new_cost
            lam = max(lam * 0.5, 1e-9)
        else:
            lam = min(lam * 4.0, 1e6)
        trace.append(cost)
    return sp, {"cost_trace": trace, "final_lam": lam}
