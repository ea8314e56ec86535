"""Bundle adjustment with Schur-complement reduction over camera blocks
(the JAX package's ``models/ba.py``).

The normal equations are assembled as batched small-block linear algebra:
U (C, 6, 6) camera blocks, V (P, 3, 3) point blocks, W (per-observation
6 x 3 cross blocks), reduced through the Schur complement
S = U - sum_p W_p V_p^-1 W_p^T to a dense (6C, 6C) camera system that
``torch.linalg.solve`` takes, as the JAX package does outside any kernel.

Every sum over observations is a reduction with a fixed order, not an
atomic scatter: sums per point run over the (P, F) ``obs_by_point`` table,
sums per camera are products with a 0/1 camera-membership matrix (one
GEMM), and the camera system is one GEMM over the points' per-camera
blocks.  So two runs of the same problem on the card give the same bits,
and the host-controlled LM loop takes the same accept / reject branches.
The order differs from the JAX package's sequential scatter, so the two
agree to rounding, not bit for bit.

Observation layout: a flat observation table (cam_idx, pt_idx, uv) plus a
per-point fixed-capacity index table obs_by_point (P, F) into it (-1 pads),
built on the host once per problem.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sift_tpu_torch.models.geometry import mat_vecs, project_points, rodrigues


@dataclasses.dataclass
class BAProblem:
    """One problem's tensors, all on one device."""

    cams: torch.Tensor          # (C, 6) [rvec, tvec]
    points: torch.Tensor        # (P, 3)
    obs_cam: torch.Tensor       # (O,) int64
    obs_pt: torch.Tensor        # (O,) int64
    obs_uv: torch.Tensor        # (O, 2) pixels
    obs_mask: torch.Tensor      # (O,) bool
    obs_by_point: torch.Tensor  # (P, F) int64 indices into obs, -1 = pad
    fxy: torch.Tensor           # (2,) focal lengths
    cxy: torch.Tensor           # (2,) principal point
    fixed_cams: torch.Tensor    # (C,) bool: gauge freeze


def build_obs_by_point(obs_pt: np.ndarray, num_points: int, cap: int | None = None):
    """Host-side (P, F) observation index table."""
    lists: list[list[int]] = [[] for _ in range(num_points)]
    for o, p in enumerate(obs_pt):
        lists[int(p)].append(o)
    f = cap or max((len(lst) for lst in lists), default=1)
    table = np.full((num_points, f), -1, np.int32)
    for p, lst in enumerate(lists):
        table[p, : min(len(lst), f)] = lst[:f]
    return table


def ba_problem_from_numpy(arrays: dict, device) -> BAProblem:
    """A ``BAProblem`` on ``device`` from its fields as numpy arrays (the
    JAX package's ``BAProblem`` fields through ``np.asarray``, or the host
    bookkeeping's own arrays): floats in their own dtype, indices as int64,
    masks as bool."""
    def f(name):
        return torch.as_tensor(np.asarray(arrays[name]), device=device)

    def i(name):
        return torch.as_tensor(np.asarray(arrays[name], np.int64), device=device)

    def b(name):
        return torch.as_tensor(np.asarray(arrays[name], bool), device=device)

    return BAProblem(cams=f("cams"), points=f("points"), obs_cam=i("obs_cam"),
                     obs_pt=i("obs_pt"), obs_uv=f("obs_uv"), obs_mask=b("obs_mask"),
                     obs_by_point=i("obs_by_point"), fxy=f("fxy"), cxy=f("cxy"),
                     fixed_cams=b("fixed_cams"))


def _residuals(pr: BAProblem, cams, points):
    uv_hat, z = project_points(cams[pr.obs_cam, :3], cams[pr.obs_cam, 3:],
                               points[pr.obs_pt][:, None, :], pr.fxy, pr.cxy)
    r = (uv_hat[:, 0, :] - pr.obs_uv) * pr.obs_mask[:, None]
    return r, z[:, 0]


def _cost(pr: BAProblem, cams, points, huber_delta: float | None = None):
    r, _ = _residuals(pr, cams, points)
    if huber_delta is None:
        return (r * r).sum()
    rn = torch.sqrt((r * r).sum(-1) + 1e-12)
    d = huber_delta
    rho = torch.where(rn <= d, rn * rn, 2.0 * d * rn - d * d)
    return (rho * pr.obs_mask).sum()


def _huber_sqrt_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt of the IRLS weight min(1, delta/||r||) per observation.

    Scaling residual and Jacobian rows by this implements a Huber loss in
    the Gauss-Newton normal equations: inliers (||r|| <= delta) keep full
    quadratic weight, outliers contribute linearly.
    """
    rn = torch.sqrt((r * r).sum(-1) + 1e-12)
    return torch.sqrt(torch.clamp(delta / rn, max=1.0))


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with skew(v) @ x = v x x."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _jacobians(pr: BAProblem, cams, points):
    """Per-observation residual + Jacobians wrt its camera (6) and point (3).

    The JAX package differentiates the projection by forward-mode AD; here
    the same derivatives are written out (forward-mode AD in PyTorch costs
    seconds of set-up on its first call in a process).  With R(w) = I +
    a [w]x + b [w]x^2 as ``rodrigues`` builds it, a and b functions of
    theta^2 = |w|^2 (their series below 1e-12, as there):

        d(R X)/dw = 2 (w x X) a' w^T - a [X]x
                    + 2 (w x (w x X)) b' w^T + b ((w . X) I + w X^T - 2 X w^T),

    and the pinhole's d(uv)/d(pc) for pc = R X + t, whose depth term is 0
    where the depth sits on its 1e-9 floor (``project_points``'s clamp).
    """
    dtype = cams.dtype
    w, t = cams[pr.obs_cam, :3], cams[pr.obs_cam, 3:]
    x = points[pr.obs_pt]
    m = pr.obs_mask.to(dtype)[:, None]
    rot = rodrigues(w)
    pc = mat_vecs(rot, x[:, None, :])[:, 0] + t
    z = torch.clamp(pc[:, 2:3], min=1e-9)
    xy = pc[:, :2] / z
    r = ((xy * pr.fxy + pr.cxy) - pr.obs_uv) * m

    # d(uv)/d(pc): (O, 2, 3)
    f_z = pr.fxy / z
    live = (pc[:, 2:3] > 1e-9).to(dtype)
    zero = torch.zeros_like(f_z[:, 0])
    d_pc = torch.stack([
        torch.stack([f_z[:, 0], zero, -f_z[:, 0] * xy[:, 0] * live[:, 0]], -1),
        torch.stack([zero, f_z[:, 1], -f_z[:, 1] * xy[:, 1] * live[:, 0]], -1),
    ], -2)

    # d(R X)/dw: (O, 3, 3)
    theta2 = (w * w).sum(-1, keepdim=True)
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    sin, cos = torch.sin(theta), torch.cos(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos) / theta2_safe)
    da = torch.where(small, torch.full_like(theta2, -1.0 / 6.0),
                     (theta * cos - sin) / (2.0 * theta2_safe * theta))
    db = torch.where(small, torch.full_like(theta2, -1.0 / 24.0),
                     (theta * sin - 2.0 * (1.0 - cos)) / (2.0 * theta2_safe * theta2_safe))
    wx = torch.linalg.cross(w, x, dim=-1)
    wwx = torch.linalg.cross(w, wx, dim=-1)
    eye = torch.eye(3, dtype=dtype, device=cams.device)
    wdotx = (w * x).sum(-1)[:, None, None]
    d_rx = (2.0 * wx[:, :, None] * (da * w)[:, None, :] - a[:, :, None] * _skew(x)
            + 2.0 * wwx[:, :, None] * (db * w)[:, None, :]
            + b[:, :, None] * (wdotx * eye + w[:, :, None] * x[:, None, :]
                               - 2.0 * x[:, :, None] * w[:, None, :]))

    def mm(p, q):  # (O, 2, 3) @ (O, 3, 3) as elementwise products and a sum
        return (p[:, :, :, None] * q[:, None, :, :]).sum(-2)

    jc = torch.cat([mm(d_pc, d_rx), d_pc], -1) * m[:, :, None]
    jp = mm(d_pc, rot) * m[:, :, None]
    return r, jc, jp


def _by_point(x: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Per-observation rows (O, ...) gathered into the (P, F, ...) table,
    zeros at the pads."""
    mask = (tbl >= 0).to(x.dtype).reshape(*tbl.shape, *([1] * (x.dim() - 1)))
    return x[tbl.clamp(min=0)] * mask


def _cam_onehot(pr: BAProblem, dtype) -> torch.Tensor:
    """(C, O) 0/1: observation o belongs to camera c."""
    c = pr.cams.shape[0]
    return (pr.obs_cam[None, :] == torch.arange(c, device=pr.obs_cam.device)[:, None]).to(dtype)


def _schur_reduce(pr: BAProblem, jc, jp, r, lam):
    """Assemble the damped, Schur-reduced camera system.

    Returns (S (C,6,C,6), rhs (C,6), V_inv (P,3,3), W tables, g_p): the
    pieces needed for back-substitution.
    """
    c = pr.cams.shape[0]
    dtype = jc.dtype
    tbl = pr.obs_by_point  # (P, F)

    jtj_c = torch.einsum("oki,okj->oij", jc, jc)  # (O, 6, 6)
    jtj_p = torch.einsum("oki,okj->oij", jp, jp)  # (O, 3, 3)
    g_c_o = torch.einsum("oki,ok->oi", jc, r)     # (O, 6)
    g_p_o = torch.einsum("oki,ok->oi", jp, r)     # (O, 3)

    onehot = _cam_onehot(pr, dtype)  # (C, O)
    u = (onehot @ jtj_c.reshape(-1, 36)).reshape(c, 6, 6)
    g_c = -(onehot @ g_c_o)
    v = _by_point(jtj_p, tbl).sum(1)   # (P, 3, 3)
    g_p = -_by_point(g_p_o, tbl).sum(1)  # (P, 3)

    # LM damping (additive, scaled by the diagonal).
    eye6 = torch.eye(6, dtype=dtype, device=jc.device)
    eye3 = torch.eye(3, dtype=dtype, device=jc.device)
    u_l = u + lam * (u * eye6) + 1e-9 * eye6
    v_l = v + lam * (v * eye3) + 1e-9 * eye3
    v_inv = torch.linalg.inv(v_l)

    # Per-point cross blocks via the obs_by_point table.
    w = torch.einsum("pfki,pfkj->pfij", _by_point(jc, tbl), _by_point(jp, tbl))  # (P, F, 6, 3)
    cam_of = pr.obs_cam[tbl.clamp(min=0)]  # (P, F)
    y = torch.einsum("pfij,pjk->pfik", w, v_inv)  # (P, F, 6, 3)

    # S = blockdiag(U_l) - sum_p sum_{a,b} Y_pa W_pb^T at (cam_a, cam_b):
    # each point's blocks placed at their cameras ((P, C, 6, 3); a pad's
    # blocks are zero), then one product over points and their 3 columns.
    member = (cam_of[:, :, None] == torch.arange(c, device=cam_of.device)).to(dtype)  # (P, F, C)
    y_c = torch.einsum("pfc,pfij->cipj", member, y).reshape(c * 6, -1)
    w_c = torch.einsum("pfc,pfij->cipj", member, w).reshape(c * 6, -1)
    s = -(y_c @ w_c.T).reshape(c, 6, c, 6)
    diag = torch.arange(c, device=s.device)
    s[diag, :, diag, :] += u_l

    # rhs_c = g_c - sum_p Y_pa g_p
    rhs_contrib = torch.einsum("pfij,pj->pfi", y, g_p)  # (P, F, 6)
    rhs = g_c - torch.einsum("pfc,pfi->ci", member, rhs_contrib)
    return s, rhs, v_inv, w, cam_of, g_p


def _solve_cameras(s, rhs, fixed):
    """Dense solve of the reduced camera system with gauge freezing."""
    c = rhs.shape[0]
    free = (~fixed).to(rhs.dtype)
    # Zero rows/cols of fixed cameras, identity on their diagonal.
    s = s * (free[:, None, None, None] * free[None, None, :, None])
    diag = torch.arange(c, device=s.device)
    eye6 = torch.eye(6, dtype=rhs.dtype, device=rhs.device)
    s[diag, :, diag, :] += (1.0 - free)[:, None, None] * eye6
    rhs = rhs * free[:, None]
    delta = torch.linalg.solve(s.reshape(c * 6, c * 6), rhs.reshape(-1))
    return delta.reshape(c, 6)


def _back_substitute(v_inv, w, cam_of, g_p, delta_c):
    """delta_p = V^-1 (g_p - sum_a W_pa^T delta_c[cam_a])."""
    dc = delta_c[cam_of]  # (P, F, 6)
    acc = torch.einsum("pfij,pfi->pj", w, dc)  # (P, 3)
    return torch.einsum("pij,pj->pi", v_inv, g_p - acc)


def ba_step(pr: BAProblem, lam: torch.Tensor, huber_delta: float | None = None):
    """One damped Gauss-Newton (LM) step; returns candidate (cams, points)."""
    r, jc, jp = _jacobians(pr, pr.cams, pr.points)
    if huber_delta is not None:
        sw = _huber_sqrt_weights(r, huber_delta)
        r = r * sw[:, None]
        jc = jc * sw[:, None, None]
        jp = jp * sw[:, None, None]
    s, rhs, v_inv, w, cam_of, g_p = _schur_reduce(pr, jc, jp, r, lam)
    delta_c = _solve_cameras(s, rhs, pr.fixed_cams)
    delta_p = _back_substitute(v_inv, w, cam_of, g_p, delta_c)
    return pr.cams + delta_c, pr.points + delta_p


def ba_solve(pr: BAProblem, iters: int = 20, lam0: float = 1e-3,
             huber_delta: float | None = None):
    """LM loop with accept/reject and damping schedule (host-controlled: one
    read of the cost per iteration, as in the JAX package).

    ``huber_delta`` (pixels): robustify with a Huber loss (IRLS weights in
    every step, Huber objective in the accept/reject test).  None keeps the
    plain L2 objective.  Returns (cams, points, info dict with cost trace).
    """
    lam = lam0
    cost = float(_cost(pr, pr.cams, pr.points, huber_delta))
    trace = [cost]
    for _ in range(iters):
        lam_t = torch.tensor(lam, dtype=pr.cams.dtype, device=pr.cams.device)
        cams_new, pts_new = ba_step(pr, lam_t, huber_delta)
        new_cost = float(_cost(pr, cams_new, pts_new, huber_delta))
        if new_cost < cost and np.isfinite(new_cost):
            pr = dataclasses.replace(pr, cams=cams_new, points=pts_new)
            cost = new_cost
            lam = max(lam * 0.5, 1e-9)
        else:
            lam = min(lam * 4.0, 1e6)
        trace.append(cost)
    return pr.cams, pr.points, {"cost_trace": trace, "final_lam": lam}
