"""A plain SfM yardstick: the yardstick that decides ``correct`` for the
incremental-SfM cells, in plain PyTorch and numpy (float64 unless a
variant says otherwise), frozen here so that a change to the program
cannot move it.  It holds three things:

1. **The scene and its ground truth.**  Three fronto-parallel planes at
   depths 9, 6 and 4 m (far at the top of the view), each a band textured
   with two 640 x 480 photographs side by side, a texel no larger than a
   pixel at the plane's depth.  A camera with intrinsics K (no lens
   distortion) at centre C with camera-to-world rotation R sees, at pixel
   (u, v) (pixel centres at integer coordinates), the ray C + s R ((u -
   cx) / fx, (v - cy) / fy, 1); the nearest plane whose band the ray meets
   gives the pixel its texel, sampled bilinearly, rounded to whole grey
   levels (an 8-bit camera).  ``trajectory`` draws the there-and-back
   path and its handheld jitter from a seed; ``render`` draws the frames.
2. **Trajectory error.**  ``ate_pct_of_path``: the camera centres after
   the similarity (Umeyama) that best fits them to the ground truth, their
   RMS distance to it per 100 of the ground truth's path length.
3. **One bundle-adjustment step.**  ``dense_step``: a Huber-IRLS,
   Levenberg-Marquardt-damped Gauss-Newton step of the reprojection error
   on the full dense normal equations, J^T J of the whole dense Jacobian
   (no Schur complement: that is the program's mechanism, which this
   checks), the Jacobians by ``torch.func`` on the projection.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# (depth m, left edge x0 m, top edge y0 m, texel m, band rows): each plane's
# texture is (rows, 1280) texels, texel (i, j) at (x0 + j s, y0 + i s, d).
PLANES = ((9.0, -6.4, -5.58, 0.0112, 418),
          (6.0, -4.3, -1.2, 0.008, 307),
          (4.0, -2.85, 0.48, 0.0057, 302))
WIDTH, HEIGHT = 640, 480


def intrinsics(camera: dict) -> np.ndarray:
    return np.array([[camera["fx"], 0.0, camera["cx"]], [0.0, camera["fy"], camera["cy"]],
                     [0.0, 0.0, 1.0]])


def textures(photos, planes=PLANES) -> list[np.ndarray]:
    """Each plane's texture, float64 RGB: two photographs side by side (the
    i-th plane the photographs 2i and 2i + 1), cut to the band's rows."""
    return [np.concatenate([photos[2 * i], photos[2 * i + 1]], 1)[:rows].astype(np.float64)
            for i, (_, _, _, _, rows) in enumerate(planes)]


def rotation(w: np.ndarray) -> np.ndarray:
    """(..., 3) rotation vectors -> (..., 3, 3) matrices, float64."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    k = np.zeros(w.shape[:-1] + (3, 3))
    k[..., 0, 1], k[..., 0, 2], k[..., 1, 2] = -w[..., 2], w[..., 1], -w[..., 0]
    k = k - np.swapaxes(k, -1, -2)
    safe = np.where(th < 1e-12, 1.0, th)
    a = np.where(th < 1e-12, 1.0, np.sin(safe) / safe)
    b = np.where(th < 1e-12, 0.5, (1.0 - np.cos(safe)) / (safe * safe))
    return np.eye(3) + a * k + b * (k @ k)


def trajectory(seed: int, outward: int = 25, length: float = 1.6,
               sigma_m: float = 0.01, sigma_deg: float = 0.5, smooth: int = 3):
    """The there-and-back path: frames 0 .. outward - 1 go ``length`` m along
    +x in equal steps; the way back revisits the outward positions
    outward - 2 down to 1.  Handheld jitter from ``seed``: per frame and
    axis white noise, averaged over ``smooth`` consecutive frames (edges
    repeated) and scaled so that the averaged jitter has standard
    deviation ``sigma_m`` in y and z and ``sigma_deg`` about each axis.
    Returns (centres (n, 3), camera-to-world rotations (n, 3, 3))."""
    xs = [length * f / (outward - 1) for f in range(outward)]
    xs += xs[outward - 2:0:-1]
    n = len(xs)
    rng = np.random.default_rng([int(seed) % 2**63, 11])
    raw = rng.normal(0.0, math.sqrt(smooth), (n + smooth - 1, 5))
    jit = np.stack([raw[i:i + smooth].mean(0) for i in range(n)])
    centres = np.stack([np.asarray(xs), sigma_m * jit[:, 0], sigma_m * jit[:, 1]], 1)
    rots = rotation(np.deg2rad(sigma_deg) * jit[:, 2:])
    return centres, rots


def poses_of(centres: np.ndarray, rots: np.ndarray) -> np.ndarray:
    """(n, 6) world-to-camera [rotation vector, t], x_cam = R^T (X - C)."""
    out = np.zeros((len(centres), 6))
    for i, (c, r) in enumerate(zip(centres, rots)):
        rt = r.T
        cos = np.clip((np.trace(rt) - 1.0) / 2.0, -1.0, 1.0)
        th = math.acos(cos)
        v = np.array([rt[2, 1] - rt[1, 2], rt[0, 2] - rt[2, 0], rt[1, 0] - rt[0, 1]])
        out[i, :3] = 0.0 if th < 1e-12 else v * (th / (2.0 * math.sin(th)))
        out[i, 3:] = -rt @ c
    return out


def cast(k: np.ndarray, centre, rot, u, v, planes=PLANES, dev="cpu"):
    """The texel each pixel (u, v) sees: (plane index (-1: none), column,
    row), float64 tensors on ``dev``."""
    f64 = torch.float64
    u = torch.as_tensor(u, dtype=f64, device=dev)
    v = torch.as_tensor(v, dtype=f64, device=dev)
    d = torch.stack([(u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1], torch.ones_like(u)], -1)
    r = torch.as_tensor(rot, dtype=f64, device=dev)
    c = torch.as_tensor(centre, dtype=f64, device=dev)
    ray = (r[None] * d.reshape(-1, 1, 3)).sum(-1).reshape(d.shape)
    best = torch.full(u.shape, math.inf, dtype=f64, device=dev)
    plane = torch.full(u.shape, -1, dtype=torch.int64, device=dev)
    col = torch.zeros_like(u)
    row = torch.zeros_like(u)
    for p, (depth, x0, y0, s, rows) in enumerate(planes):
        lam = (depth - c[2]) / ray[..., 2]
        j = (c[0] + lam * ray[..., 0] - x0) / s
        i = (c[1] + lam * ray[..., 1] - y0) / s
        hit = (lam > 0) & (lam < best) & (j >= 0) & (j <= 1279) & (i >= 0) & (i <= rows - 1)
        best = torch.where(hit, lam, best)
        plane = torch.where(hit, p, plane)
        col = torch.where(hit, j, col)
        row = torch.where(hit, i, row)
    return plane, col, row


def texel_point(plane: int, col, row, planes=PLANES) -> np.ndarray:
    """The world point of texel (col, row) of plane ``plane``."""
    depth, x0, y0, s, _ = planes[plane]
    col, row = np.asarray(col, np.float64), np.asarray(row, np.float64)
    return np.stack([x0 + col * s, y0 + row * s, np.full_like(col, depth)], -1)


def project(k: np.ndarray, centre, rot, x: np.ndarray) -> np.ndarray:
    """Pixels of world points ``x`` (n, 3) seen by the camera (centre, rot)."""
    pc = (np.asarray(x, np.float64) - centre) @ rot
    return np.stack([k[0, 0] * pc[:, 0] / pc[:, 2] + k[0, 2],
                     k[1, 1] * pc[:, 1] / pc[:, 2] + k[1, 2]], -1)


def render(k: np.ndarray, centre, rot, tex: list, dev="cpu", shape=(HEIGHT, WIDTH),
           planes=PLANES) -> np.ndarray:
    """One frame: (H, W, 3) float32 whole grey levels; a pixel that meets no
    plane is black.  ``tex``: the planes' textures on ``dev`` (float64)."""
    h, w = shape
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                          torch.arange(w, dtype=torch.float64, device=dev), indexing="ij")
    plane, col, row = cast(k, centre, rot, u, v, planes, dev)
    out = torch.zeros((h, w, 3), dtype=torch.float64, device=dev)
    for p, t in enumerate(tex):
        m = plane == p
        j, i = col[m], row[m]
        j0 = torch.clamp(torch.floor(j), max=t.shape[1] - 2)
        i0 = torch.clamp(torch.floor(i), max=t.shape[0] - 2)
        fj, fi = (j - j0)[:, None], (i - i0)[:, None]
        j0, i0 = j0.long(), i0.long()
        out[m] = ((1 - fi) * ((1 - fj) * t[i0, j0] + fj * t[i0, j0 + 1])
                  + fi * ((1 - fj) * t[i0 + 1, j0] + fj * t[i0 + 1, j0 + 1]))
    return torch.clamp(torch.round(out), 0, 255).to(torch.float32).cpu().numpy()


# ---- trajectory error -------------------------------------------------------

def centres_of(poses: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t of (n, 6) world-to-camera poses, float64."""
    poses = np.asarray(poses, np.float64)
    return -np.einsum("nji,nj->ni", rotation(poses[:, :3]), poses[:, 3:])


def umeyama(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``src`` after the similarity (scale, rotation, translation) that
    best fits it to ``dst`` in least squares (Umeyama 1991)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    s0, d0 = src - mu_s, dst - mu_d
    u, sig, vt = np.linalg.svd(d0.T @ s0 / len(src))
    e = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        e[2, 2] = -1.0
    r = u @ e @ vt
    scale = float(np.trace(np.diag(sig) @ e) / max((s0 * s0).sum() / len(src), 1e-12))
    return (scale * (r @ s0.T)).T + mu_d


def ate_pct_of_path(centres: np.ndarray, gt: np.ndarray) -> float:
    """RMS distance of the aligned centres to the ground truth, per 100 of
    the ground truth's path length (the TUM benchmark's ATE, after a
    similarity: monocular SfM has no scale)."""
    aligned = umeyama(np.asarray(centres, np.float64), np.asarray(gt, np.float64))
    ate = math.sqrt(((aligned - gt) ** 2).sum(1).mean())
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return 100.0 * ate / max(path, 1e-9)


# ---- one bundle-adjustment step --------------------------------------------

def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    th2 = (w * w).sum()
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    z = torch.zeros_like(w[0])
    k = torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * k + b * (k @ k)


def _project1(cam, x, fxy, cxy):
    pc = _rodrigues(cam[:3]) @ x + cam[3:]
    z = torch.clamp(pc[2], min=1e-9)
    return pc[:2] / z * fxy + cxy


def dense_step(problem: dict, lam: float, huber_delta: float | None, dev="cpu",
               dtype=torch.float64, tf32: bool = False):
    """One damped Gauss-Newton step of the problem's reprojection error on
    the full dense normal equations: (delta cams (C, 6), delta points (P,
    3)) as float64 numpy.

    ``problem``: numpy arrays ``cams`` (C, 6) [rotation vector, t],
    ``points`` (P, 3), ``obs_cam``, ``obs_pt``, ``obs_uv`` (O, 2),
    ``obs_mask``, ``fxy``, ``cxy``, ``fixed_cams`` (C,).  Residual r_o =
    project(cam, X) - uv (zero where masked).  With ``huber_delta`` each
    observation's residual and Jacobian rows are weighted by sqrt(min(1,
    delta / sqrt(|r|^2 + 1e-12))) (IRLS).  A = J^T J over every camera and
    point unknown (a product of the dense (2 O, 6 C + 3 P) Jacobian with
    itself), damped A + lam diag(A) + 1e-9 I, solved for -J^T r with the
    fixed cameras' unknowns held at 0.  ``dtype`` / ``tf32``: the
    precision of everything after the problem's numbers are read (the
    controls); the answer is float64 numpy either way."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _dense_step(problem, lam, huber_delta, dev, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dense_step(problem, lam, huber_delta, dev, dtype):
    def t(name):
        return torch.as_tensor(np.asarray(problem[name]), device=dev)

    cams, pts = t("cams").to(dtype), t("points").to(dtype)
    oc, op = t("obs_cam").long(), t("obs_pt").long()
    uv, m = t("obs_uv").to(dtype), t("obs_mask").to(dtype)
    fxy, cxy = t("fxy").to(dtype), t("cxy").to(dtype)
    fixed = t("fixed_cams").bool()
    n_c, n_p = len(cams), len(pts)

    proj = torch.func.vmap(_project1, in_dims=(0, 0, None, None))
    jac = torch.func.vmap(torch.func.jacrev(_project1, argnums=(0, 1)),
                          in_dims=(0, 0, None, None))
    r = (proj(cams[oc], pts[op], fxy, cxy) - uv) * m[:, None]
    jc, jp = jac(cams[oc], pts[op], fxy, cxy)
    j = torch.cat([jc, jp], -1) * m[:, None, None]  # (O, 2, 9)
    if huber_delta is not None:
        rn = torch.sqrt((r * r).sum(-1) + 1e-12)
        sw = torch.sqrt(torch.clamp(huber_delta / rn, max=1.0))
        r, j = r * sw[:, None], j * sw[:, None, None]

    # The whole Jacobian, dense: row 2 o + k of observation o's residual k,
    # its camera's 6 columns then its point's 3; A = J^T J and J^T r as
    # matrix products.
    cols = torch.cat([oc[:, None] * 6 + torch.arange(6, device=dev),
                      6 * n_c + op[:, None] * 3 + torch.arange(3, device=dev)], 1)  # (O, 9)
    n = 6 * n_c + 3 * n_p
    jd = torch.zeros((2 * len(oc), n), dtype=dtype, device=dev)
    rows = torch.arange(2 * len(oc), device=dev).reshape(-1, 2, 1).expand(-1, 2, 9)
    jd[rows.reshape(-1), cols[:, None, :].expand(-1, 2, 9).reshape(-1)] = j.reshape(-1)
    a = jd.T @ jd
    g = jd.T @ r.reshape(-1)
    del jd
    diag = torch.diagonal(a)
    diag += lam * diag.clone() + 1e-9
    # The fixed cameras' unknowns: rows and columns cleared, 1 on the
    # diagonal, 0 on the right: they come out 0 and decouple from the rest.
    held = torch.nonzero(fixed)[:, 0][:, None] * 6 + torch.arange(6, device=dev)
    held = held.reshape(-1)
    a[held, :] = 0
    a[:, held] = 0
    a[held, held] = 1
    g[held] = 0
    chol, info = torch.linalg.cholesky_ex(a)
    if int(info) == 0:
        del a
        x = torch.cholesky_solve(-g[:, None], chol)[:, 0]
    else:  # not numerically positive definite in this precision
        del chol
        x = torch.linalg.solve(a, -g)
    out = x.to(torch.float64).cpu().numpy()
    return out[:6 * n_c].reshape(n_c, 6), out[6 * n_c:].reshape(n_p, 3)


def step_off_pct(prog: tuple, ref: tuple) -> float:
    """The relative L2 distance of a step (delta cams, delta points) to the
    reference's, per 100."""
    p = np.concatenate([np.ravel(prog[0]), np.ravel(prog[1])]).astype(np.float64)
    q = np.concatenate([np.ravel(ref[0]), np.ravel(ref[1])]).astype(np.float64)
    return 100.0 * float(np.linalg.norm(p - q)) / max(float(np.linalg.norm(q)), 1e-300)
