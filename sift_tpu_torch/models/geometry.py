"""Multi-view geometry primitives (the JAX package's ``models/geometry.py``).

Everything is fixed-shape and batched: RANSAC runs as a fixed block of
hypotheses, never as a data-dependent loop.  Each RANSAC function comes in
two parts, as the stitching slice's homography does: a public function
that draws its samples (``sample_choice``: a CPU generator, so the CPU and
the card take the same hypotheses) and a ``*_with_samples`` function that
takes them and runs on the points' device without a host read.

No stage here has a TPU kernel in the JAX package (they are XLA), so all of
it is plain PyTorch.  Small products (3 x 3 rotations, the projections of
points) are written out as elementwise products and sums: they round alike
on every call, where a CPU BLAS may round a batched product differently
from call to call (its path follows the operands' alignment), and RANSAC's
choice between near-tied hypotheses must not move with it.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.numerics import device_const


def min_eigvec(a: torch.Tensor) -> torch.Tensor:
    """Least-squares null vector of (..., M, D) via the D x D normal
    equations and ``eigh``: the eigenvector of the smallest eigenvalue, the
    same minimizer as the SVD null vector.  Its sign is arbitrary.

    The normal matrix is a sum of elementwise products, not a BLAS product
    (see the module docstring).  On the card ``eigh`` reads its solver's
    status to the host, a wait marked ``geometry.sync.eigh`` (the stitching
    refit's, and the SfM solves' through this function).
    """
    ata = (a[..., :, :, None] * a[..., :, None, :]).sum(-3)
    with profiling.span("geometry.sync.eigh"):
        _, vecs = torch.linalg.eigh(ata)
    return vecs[..., :, 0]


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, K) @ (..., K, 3) as elementwise products and a sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def mat_vecs(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Each row of ``x`` (..., N, 3) through ``m`` (..., 3, 3): (..., N, 3),
    ``m @ x_n`` as three products and two sums per entry."""
    m = m[..., None, :, :]
    x = x[..., :, None, :]
    return m[..., 0] * x[..., 0] + m[..., 1] * x[..., 1] + m[..., 2] * x[..., 2]


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """so(3) -> SO(3) exponential map. rvec (..., 3) -> (..., 3, 3).

    Uses the unnormalized skew form R = I + A[w]x + B[w]x^2 with Taylor
    series for small angles.  Both branches of each ``where`` stay finite
    (``theta2_safe``), so forward- and reverse-mode derivatives are finite
    at rvec = 0, where bundle adjustment linearizes all the time: a
    ``where`` passes ``0 * nan = nan`` through the branch it did not pick.
    """
    theta2 = (rvec * rvec).sum(-1, keepdim=True)
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    wx, wy, wz = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zero = torch.zeros_like(wx)
    k = torch.stack([
        torch.stack([zero, -wz, wy], -1),
        torch.stack([wz, zero, -wx], -1),
        torch.stack([-wy, wx, zero], -1),
    ], -2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None] * k + b[..., None] * matmul3(k, k)


def project_points(rvec, tvec, pts3d, fxy, cxy):
    """Pinhole projection: (..., N, 3) world points -> ((..., N, 2) pixels,
    (..., N) camera depths), with x_cam = R X + t."""
    pc = mat_vecs(rodrigues(rvec), pts3d) + tvec[..., None, :]
    z = torch.clamp(pc[..., 2:3], min=1e-9)
    xy = pc[..., :2] / z
    return xy * fxy + cxy, pc[..., 2]


def triangulate(p1, p2, r1, t1, r2, t2):
    """Linear (DLT) triangulation of normalized image points.

    p1, p2: (N, 2) normalized coordinates in cameras (r1, t1), (r2, t2) with
    projection x = R X + t; each camera either one (3, 3) / (3,) pose for
    all rows or one per row, (N, 3, 3) / (N, 3).  Returns (N, 3) points.
    """
    def rows(p, r, t):
        pr = torch.cat([r, t[..., None]], -1)  # (..., 3, 4)
        a1 = p[:, 0:1] * pr[..., 2, :] - pr[..., 0, :]
        a2 = p[:, 1:2] * pr[..., 2, :] - pr[..., 1, :]
        return a1, a2

    a1, a2 = rows(p1, r1, t1)
    a3, a4 = rows(p2, r2, t2)
    a = torch.stack(torch.broadcast_tensors(a1, a2, a3, a4), 1)  # (N, 4, 4)
    x = min_eigvec(a)
    w = x[:, 3:]
    return x[:, :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)


def _essential_rows(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """The 8-point rows x2^T E x1 = 0: (..., N, 2) pairs -> (..., N, 9)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], -1)


def _project_essential(e: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) onto the essential manifold: singular values (1, 1, 0).
    The product does not depend on how the singular vectors are signed."""
    u, _, vt = torch.linalg.svd(e)
    s = device_const((1.0, 1.0, 0.0), e.dtype, e.device)
    return matmul3(u, s[:, None] * vt)


def _essential_from_8pt(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Batched 8-point essential matrix: (..., 8, 2) pairs -> (..., 3, 3).

    Inputs are normalized (calibrated) coordinates; the rank/eigenvalue
    constraint diag(1, 1, 0) is enforced by SVD projection.
    """
    a = _essential_rows(p1, p2)
    return _project_essential(min_eigvec(a).reshape(*a.shape[:-2], 3, 3))


def _sampson_err2(e: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance: e (..., 3, 3), p (N, 2) -> (..., N)."""
    ones = torch.ones_like(p1[..., :1])
    x1 = torch.cat([p1, ones], -1)
    x2 = torch.cat([p2, ones], -1)
    ex1 = mat_vecs(e, x1)  # (..., N, 3)
    etx2 = mat_vecs(e.transpose(-1, -2), x2)
    x2ex1 = x2[..., 0] * ex1[..., 0] + x2[..., 1] * ex1[..., 1] + x2[..., 2] * ex1[..., 2]
    denom = ex1[..., 0] ** 2 + ex1[..., 1] ** 2 + etx2[..., 0] ** 2 + etx2[..., 1] ** 2
    return x2ex1 ** 2 / torch.clamp(denom, min=1e-12)


def sample_choice(valid: torch.Tensor, num_hypotheses: int, m: int, seed: int = 0) -> torch.Tensor:
    """(K, m) int64 indices of valid lanes, drawn uniformly with replacement,
    on ``valid``'s device: the distribution of the JAX package's
    ``jax.random.choice(..., p=valid / valid.sum())``, not its stream.

    The uniforms come from a CPU ``torch.Generator`` seeded with ``seed``;
    each picks the lane of the ``floor(u * n_valid)``-th valid entry by a
    search in the running count of valid lanes, on the device.  The same
    seed and mask give the same indices on the CPU and on the card, and
    nothing is read back to the host.  With no valid lane every index is
    the last lane (every hypothesis then scores zero inliers).
    """
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    u = torch.rand((num_hypotheses, m), generator=gen, dtype=torch.float64)
    if valid.device.type == "cuda":  # a pinned copy does not wait for the card
        u = u.pin_memory().to(valid.device, non_blocking=True)
    cdf = torch.cumsum(valid.to(torch.int64), 0)
    target = torch.floor(u * cdf[-1].to(torch.float64)).to(torch.int64)
    idx = torch.searchsorted(cdf, target, right=True)
    return idx.clamp(max=valid.shape[0] - 1)


def _first_max(counts: torch.Tensor) -> torch.Tensor:
    """(1,) index of the first maximum (``jnp.argmax``'s rule), kept on the
    device: indexing by a 0-dim tensor would read it to the host."""
    return torch.argmax(counts).view(1)


def ransac_essential(p1, p2, valid, num_hypotheses: int = 1024,
                     inlier_threshold: float = 1e-3, seed: int = 0):
    """Essential matrix from normalized correspondences, batched RANSAC.

    Returns (E (3,3), inlier_mask, num_inliers) on the points' device.
    """
    idx = sample_choice(valid, num_hypotheses, 8, seed)
    return ransac_essential_with_samples(p1, p2, valid, idx, inlier_threshold)


def ransac_essential_with_samples(p1, p2, valid, idx, inlier_threshold: float = 1e-3):
    """``ransac_essential`` on given (K, 8) sample indices."""
    e = _essential_from_8pt(p1[idx], p2[idx])
    thr2 = inlier_threshold ** 2
    inl = (_sampson_err2(e, p1, p2) < thr2) & valid[None, :]
    counts = inl.sum(1)
    best = _first_max(counts)
    e_best = e.index_select(0, best)[0]
    mask = inl.index_select(0, best)[0]

    # Refit on all inliers (weighted 8-point over the full set).
    a = _essential_rows(p1, p2) * mask.to(p1.dtype)[:, None]
    e_ref = _project_essential(min_eigvec(a).reshape(3, 3))
    inl_r = (_sampson_err2(e_ref[None], p1, p2)[0] < thr2) & valid
    use_refit = inl_r.sum() >= counts.index_select(0, best)[0]
    e_out = torch.where(use_refit, e_ref, e_best)
    mask_out = torch.where(use_refit, inl_r, mask)
    return e_out, mask_out, mask_out.sum()


def recover_pose(e: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor):
    """Decompose E into the (R, t) with maximal cheirality support.

    Convention: x2 = R x1 + t (camera 1 at identity).  Returns (R, t, front
    mask) with |t| = 1.  The four candidates are taken in the JAX package's
    order and the first maximum wins, but which of (R, +-t) comes first
    follows the signs the SVD gives its vectors, which LAPACK and cuSOLVER
    may choose differently: compare rotations and centres, not positions.
    """
    u, _, vt = torch.linalg.svd(e)
    # Ensure proper rotations.
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))[..., None]
    w = device_const((0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0), e.dtype,
                     e.device).view(3, 3)
    r_a = matmul3(matmul3(u, w), vt)
    r_b = matmul3(matmul3(u, w.T), vt)
    t_u = u[:, 2]
    eye = torch.eye(3, dtype=e.dtype, device=e.device)
    zero = torch.zeros(3, dtype=e.dtype, device=e.device)

    rs = torch.stack([r_a, r_a, r_b, r_b])
    ts = torch.stack([t_u, -t_u, t_u, -t_u])
    fronts = []
    for r, t in zip(rs, ts):
        x = triangulate(p1, p2, eye, zero, r, t)
        z2 = mat_vecs(r, x)[:, 2] + t[2]
        fronts.append((x[:, 2] > 0) & (z2 > 0) & valid)
    fronts = torch.stack(fronts)
    best = _first_max(fronts.sum(1))
    return rs.index_select(0, best)[0], ts.index_select(0, best)[0], fronts.index_select(0, best)[0]


def rotation_log(r: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation -> (3,) rotation vector by the arccos log map (the
    JAX package's, which loses precision in float32 near theta = 0)."""
    cos = torch.clamp((r[0, 0] + r[1, 1] + r[2, 2] - 1) / 2, -1.0, 1.0)
    theta = torch.arccos(cos)
    axis = torch.stack([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis), min=1e-12)
    return axis * theta


def ransac_pnp(pts3d, pts2d, valid, num_hypotheses: int = 1024,
               inlier_threshold: float = 8e-3, seed: int = 0):
    """Camera pose from 3D-2D correspondences (normalized 2D), DLT + RANSAC.

    Returns (rvec, tvec, inlier_mask, count) with x_cam = R X + t, on the
    points' device.  Minimal sample: 6 points (linear DLT of the 3x4
    projection matrix).
    """
    idx = sample_choice(valid, num_hypotheses, 6, seed)
    return ransac_pnp_with_samples(pts3d, pts2d, valid, idx, inlier_threshold)


def ransac_pnp_with_samples(pts3d, pts2d, valid, idx, inlier_threshold: float = 8e-3):
    """``ransac_pnp`` on given (K, 6) sample indices."""
    x3 = pts3d[idx]  # (K, 6, 3)
    x2 = pts2d[idx]  # (K, 6, 2)
    xh = torch.cat([x3, torch.ones_like(x3[..., :1])], -1)  # (K, 6, 4)
    z = torch.zeros_like(xh)
    r1 = torch.cat([xh, z, -x2[..., 0:1] * xh], -1)
    r2 = torch.cat([z, xh, -x2[..., 1:2] * xh], -1)
    p = min_eigvec(torch.cat([r1, r2], -2)).reshape(-1, 3, 4)  # (K, 3, 4)

    # Decompose P = [M | p4] -> R, t with orthogonalization of M.
    p = p * torch.sign(torch.linalg.det(p[:, :, :3]))[:, None, None]
    u, s, vtm = torch.linalg.svd(p[:, :, :3])
    r = matmul3(u, vtm)
    scale = s.mean(-1)
    t = p[:, :, 3] / torch.clamp(scale, min=1e-12)[:, None]

    pc = mat_vecs(r, pts3d) + t[:, None, :]  # (K, N, 3)
    zc = pc[..., 2:]
    proj = pc[..., :2] / torch.where(zc.abs() < 1e-9, torch.full_like(zc, 1e-9), zc)
    err2 = ((proj - pts2d[None]) ** 2).sum(-1)
    inl = (err2 < inlier_threshold ** 2) & (pc[..., 2] > 0) & valid[None, :]
    counts = inl.sum(1)
    best = _first_max(counts)
    rvec = rotation_log(r.index_select(0, best)[0])
    return rvec, t.index_select(0, best)[0], inl.index_select(0, best)[0], counts.index_select(0, best)[0]
