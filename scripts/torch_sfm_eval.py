"""SfM accuracy of the port (sift_tpu_torch) on rendered trajectories with
ground truth: the counterpart of ``scripts/sfm_eval.py``.

The sequences are the JAX script's: a lateral sweep of ``--frames``
frames, a there-and-back loop (revisited viewpoints exercise track merging
across non-adjacent frames), and the multi-pass loop with and without the
loop-closure repair, each rendered as planar texture bands at three depths
(320 x 240, fx 300) from CAVE-01 frame 00 as the oracle decoded it
(tests/data/scene_oracle/cave01_00.npz), and each run through
``run_sfm(.., ba_iters=20)``.  Reports ATE-RMSE after similarity (Umeyama)
alignment, since monocular SfM recovers scale only up to gauge, and RPE
per frame step: one JSON line per sequence, with its seconds, registered
frames and each hand-written kernel's launches.  ``--out FILE`` appends a
markdown table in SFM.md's format to FILE.

    python scripts/torch_sfm_eval.py [--frames 50] [--out FILE] [--device cpu]

Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sift_tpu_torch import SiftConfig  # noqa: E402
from sift_tpu_torch.models.geometry import rodrigues  # noqa: E402
from sift_tpu_torch.models.sfm import run_sfm  # noqa: E402
from sift_tpu_torch.parallel.multihost import kernel_wrappers  # noqa: E402
from sift_tpu_torch.utils.numerics import resolve_device  # noqa: E402

K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]])
CAPS = dict(extrema_cap=2048, kp_cap=1024, ori_cap=2048)
BA_ITERS = 20


def _aligned(centers: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """``centers`` after the similarity (Umeyama) that best fits them to
    ``gt``."""
    mu_c = centers.mean(axis=0)
    mu_g = gt.mean(axis=0)
    cc = centers - mu_c
    gg = gt - mu_g
    cov = gg.T @ cc / len(cc)
    u, d, vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        sgn[2, 2] = -1
    r = u @ sgn @ vt
    var_c = (cc * cc).sum() / len(cc)
    s = float(np.trace(np.diag(d) @ sgn) / max(var_c, 1e-12))
    return (s * (r @ cc.T)).T + mu_g


def _metrics(centers: np.ndarray, gt: np.ndarray) -> dict:
    """ATE-RMSE after similarity (Umeyama) alignment + RPE per frame step.

    Monocular SfM recovers the trajectory up to a similarity: the gauge fixes
    the init pair (not frame 0) and the scale is arbitrary, so ATE must be
    computed after the best-fit rotation+translation+scale, exactly like the
    TUM evaluation protocol.
    """
    aligned = _aligned(centers, gt)
    ate = float(np.sqrt(((aligned - gt) ** 2).sum(axis=1).mean()))
    d_rec = np.diff(aligned, axis=0)
    d_gt = np.diff(gt, axis=0)
    rpe = float(np.sqrt(((d_rec - d_gt) ** 2).sum(axis=1).mean()))
    path = float(np.linalg.norm(d_gt, axis=1).sum())
    return {"ate_rmse_m": ate, "rpe_rmse_m": rpe, "path_m": path,
            "ate_pct_of_path": 100.0 * ate / max(path, 1e-9)}


def trajectory_metrics(centers: np.ndarray, gt: np.ndarray) -> dict:
    """``_metrics`` with the RPE as a % of the path and the largest aligned
    deviation."""
    m = _metrics(centers, gt)
    m["rpe_pct_of_path"] = 100.0 * m["rpe_rmse_m"] / max(m["path_m"], 1e-9)
    m["max_dev_m"] = float(np.linalg.norm(_aligned(centers, gt) - gt, axis=1).max())
    return m


def camera_centers(poses: np.ndarray) -> np.ndarray:
    """(C, 3) centres -R^T t of (C, 6) [rvec, tvec] poses, in float64."""
    r = rodrigues(torch.as_tensor(poses[:, :3], dtype=torch.float64)).numpy()
    return -np.einsum("nji,nj->ni", r, poses[:, 3:])


def texture() -> np.ndarray:
    """CAVE-01 frame 00 as float32 RGB (the oracle's decoded pixels of the
    photograph the JAX script renders from)."""
    path = os.path.join(ROOT, "tests", "data", "scene_oracle", "cave01_00.npz")
    return np.load(path)["input"].astype(np.float32)[:, :, :3]


def render_sequence(tex=None, n_frames=6, w=320, h=240, fx=300.0, baseline=0.08, ts=None):
    """Planar-stack renderer: three texture bands at depths 4/6/9 units.

    Camera translates along +x by ``baseline`` per frame (or follows the
    explicit per-frame ``ts`` trajectory, enabling loops/revisits); a plane
    at depth d shifts by fx * t / d pixels.  ``tex``: (H, W, 3) float32
    (default ``texture()``).  Returns (frames, gt_centers).
    """
    tex = texture() if tex is None else tex
    tex = tex[: h + 60, : w + 120]
    depths = [9.0, 6.0, 4.0]
    # horizontal bands (far at top), each a slice of the texture
    bands = [tex[i * 80: i * 80 + 100] for i in range(3)]
    frames = []
    centers = []
    if ts is None:
        ts = [f * baseline for f in range(n_frames)]
    for t in ts:
        img = np.zeros((h, w, 3), np.float32)
        for band, d in zip(bands, depths):
            shift = fx * t / d
            # Subpixel sampling: integer rounding here would corrupt the
            # ground truth itself (up to 0.5 px/frame of fake motion).
            x0 = int(np.floor(shift))
            frac = np.float32(shift - x0)
            lo = band[:, x0: x0 + w]
            hi = band[:, x0 + 1: x0 + 1 + w]
            src = (1 - frac) * lo[:, : hi.shape[1]] + frac * hi
            y0 = {9.0: 0, 6.0: 80, 4.0: 160}[d]
            img[y0: y0 + src.shape[0], : src.shape[1]] = src[: h - y0]
        frames.append(img)
        centers.append(np.array([t, 0.0, 0.0]))
    return frames, np.stack(centers)


def sequences(n: int) -> dict:
    """The camera positions of the JAX script's sequences: sweep-n (a
    constant baseline of 1.6 / n; the texture caps the near band's shift at
    about 120 px), the there-and-back loop, and the multi-pass loop (out,
    back, out again)."""
    base = 1.6 / n
    half = max(n // 2, 4)
    loop = [f * base for f in range(half)] + [(half - 2 - f) * base for f in range(half - 1)]
    seg = max((2 * n) // 3, 4)
    step = 1.6 / seg
    big = ([f * step for f in range(seg)] + [(seg - 2 - f) * step for f in range(seg - 1)]
           + [(f + 1) * step for f in range(seg - 1)])
    return {f"sweep-{n}": [f * base for f in range(n)], f"loop-{len(loop)}": loop,
            f"bigloop-{len(big)}": big}


def evaluate(name: str, frames, gt, cfg: SiftConfig, device, loop_closure: bool = True) -> dict:
    """One sequence through ``run_sfm`` on ``device``: its JSON record, with
    each hand-written kernel's launches in the run."""
    dev = resolve_device(device)
    counted = kernel_wrappers()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = run_sfm(frames, K, cfg, ba_iters=BA_ITERS, loop_closure=loop_closure, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    el = time.perf_counter() - t0
    m = _metrics(camera_centers(res.poses), gt)
    m.update(seq=name, frames=len(frames), seconds=el, registered=len(res.info["registered"]),
             points=res.info["n_points"], obs=res.info["n_obs"],
             pruned=res.info.get("pruned_obs", 0),
             launches={k: fn.launches for k, fn in counted.items()})
    return m


def table(rows, platform: str) -> str:
    """SFM.md's markdown table of the records."""
    lines = [
        "",
        f"## Recorded run ({time.strftime('%Y-%m-%d')}, {platform})",
        "",
        "| sequence | frames | ATE-RMSE | % of path | RPE-RMSE | points "
        "| obs | pruned | seconds |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for m in rows:
        lines.append(
            f"| {m['seq']} | {m['frames']} | {m['ate_rmse_m']*100:.2f} cm "
            f"| {m['ate_pct_of_path']:.2f}% | {m['rpe_rmse_m']*100:.2f} cm "
            f"| {m['points']} | {m['obs']} | {m['pruned']} "
            f"| {m['seconds']:.1f} |"
        )
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--out", default=None, help="append the markdown table to this file")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = SiftConfig(**CAPS)
    tex = texture()
    rows = []
    for name, ts in sequences(args.frames).items():
        frames, gt = render_sequence(tex, ts=ts)
        runs = [(name, True)]
        if name.startswith("bigloop-"):  # the window-only baseline the repair is measured against
            runs.append((f"{name}-noclosure", False))
        for seq, closure in runs:
            m = evaluate(seq, frames, gt, cfg, dev, loop_closure=closure)
            rows.append(m)
            print(json.dumps(m), flush=True)
    if args.out:
        platform = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        with open(args.out, "a") as f:
            f.write(table(rows, f"sift_tpu_torch, {platform}"))
        print(f"appended to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
