"""The loop-closure flow stage by stage on the multi-pass loop, on the card:
the counterpart of ``scripts/sfm_pgo_debug.py`` for the port
(sift_tpu_torch).

Renders the JAX script's loop (out, back and out again: ``seg = max(2 N /
3, 4)`` frames a pass at a step of 1.6 / seg, 3 seg - 2 frames; N = 50
gives its 97 frames) with ``scripts/torch_sfm_eval.py``'s renderer,
detects every frame (kernels D and F on the card) and matches the pairs
(i, i + 1) and (i, i + 2) (kernel B), then isolates each stage of the
repair:

1. ``base``: ``run_sfm_from_matches(.., 20)`` on the window matches;
2. closures: ``loop_closure_candidates(descs, 8, min_sim=0.95)`` not
   already matched, gated on the base solve's centres (gap at most 0.1 x
   the registered path) and at least 24 matches, each with the
   ``_relative_rotation`` of its normalised bearings;
3. ``after PGO``: ``pose_graph_relax`` of the base poses (the points are
   the base solve's);
4. ``after refine BA``: ``run_sfm_from_matches`` in refine mode from the
   relaxed poses (``poses_init`` / ``registered_init``).

Prints the JAX script's lines (``base:``, ``closures:``, ``pgo:``, ``after
PGO:``, ``after refine BA:``), each followed by a JSON record: the
trajectory metrics (ATE-RMSE after similarity alignment, RPE, the path,
ATE % of the path; over every frame, as the JAX script measures them, so
a frame left unregistered counts at its zero pose), the frames
registered, and the kernels' launches.

    python scripts/torch_sfm_pgo_debug.py [--frames 50] [--device cpu]

``--frames N`` (default 50, which the JAX script fixes) exists so that a
test on the CPU can run a small loop.  Runs on the card unless ``--device
cpu``; without a card it raises.
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

import chip_smoke as C  # noqa: E402
from sift_tpu_torch.models.geometry import rodrigues  # noqa: E402
from sift_tpu_torch.models.sfm import (  # noqa: E402
    SfmResult,
    _normalize,
    _relative_rotation,
    loop_closure_candidates,
    pose_graph_relax,
    run_sfm_from_matches,
)
from sift_tpu_torch.parallel.multihost import kernel_wrappers  # noqa: E402
from sift_tpu_torch.utils.numerics import resolve_device  # noqa: E402

EV = C.port_script("torch_sfm_eval")
AB = C.port_script("torch_sfm_ablate")
K = EV.K
BA_ITERS = EV.BA_ITERS


def loop_positions(n: int) -> list[float]:
    """The JAX script's camera positions: three passes of ``seg`` frames."""
    seg = max((2 * n) // 3, 4)
    step = 1.6 / seg
    return ([f * step for f in range(seg)] + [(seg - 2 - f) * step for f in range(seg - 1)]
            + [(f + 1) * step for f in range(seg - 1)])


def closures_of(base: SfmResult, kps, uvs, pair_matches, match_pair):
    """The JAX script's closures from the base solve: (i, j, R) for each
    retrieval candidate not already matched, whose base centres lie within
    0.1 x the registered path (centres from float32 rotations, as the JAX
    script computes them) and whose pair has at least 24 matches; also the
    candidates themselves."""
    reg = sorted(base.info["registered"])
    rm = rodrigues(torch.as_tensor(base.poses[:, :3], dtype=torch.float32)).double().numpy()
    centers = -np.einsum("nij,nj->ni", rm.transpose(0, 2, 1), base.poses[:, 3:])
    path = float(sum(np.linalg.norm(centers[b] - centers[a]) for a, b in zip(reg, reg[1:])))
    descs = [kp.desc[kp.valid].cpu().numpy() for kp in kps]
    cands = loop_closure_candidates(descs, 8, min_sim=0.95)
    closures = []
    for i, j in cands:
        if (i, j) in pair_matches:
            continue
        if float(np.linalg.norm(centers[i] - centers[j])) > 0.1 * path:
            continue
        m = match_pair(i, j)
        if len(m) < 24:
            continue
        closures.append((i, j, _relative_rotation(_normalize(uvs[i][m[:, 0]], K),
                                                  _normalize(uvs[j][m[:, 1]], K))))
    return closures, cands


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=50,
                    help="N of the loop's 3 max(2N/3, 4) - 2 frames (the JAX script fixes 50; "
                         "a smaller N is for a quick run on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    counted = kernel_wrappers()
    for fn in counted.values():
        fn.launches = 0
    frames, gt = EV.render_sequence(EV.texture(), ts=loop_positions(args.frames))
    n = len(frames)

    def record(stage, poses, res=None, **kw):
        m = EV._metrics(EV.camera_centers(poses), gt)
        print(f"{stage}:", {k: round(v, 4) for k, v in m.items()}, flush=True)
        m.update(stage=stage, frames=n, launches={k: fn.launches for k, fn in counted.items()},
                 **kw)
        if res is not None:
            m.update(registered=len(res.info["registered"]), points=res.info["n_points"],
                     obs=res.info["n_obs"], pruned=res.info.get("pruned_obs", 0))
        print(json.dumps(m), flush=True)

    t0 = time.perf_counter()
    kps, uvs, pair_matches, match_pair = AB.detect_and_match(frames, dev, window=2)
    base = run_sfm_from_matches(uvs, dict(pair_matches), K, BA_ITERS, device=dev)
    record("base", base.poses, base, seconds=time.perf_counter() - t0, pairs=len(pair_matches))

    closures, cands = closures_of(base, kps, uvs, pair_matches, match_pair)
    pairs = [[i, j] for i, j, _ in closures]
    print(f"closures: {len(closures)} pairs {[tuple(p) for p in pairs][:8]}...", flush=True)
    print(json.dumps(dict(stage="closures", candidates=[list(c) for c in cands],
                          closures=pairs)), flush=True)

    reg = base.info["registered"]
    t0 = time.perf_counter()
    poses_pgo = pose_graph_relax(base.poses, reg, closures)
    pgo_s = time.perf_counter() - t0
    print(f"pgo: {pgo_s:.1f}s", flush=True)
    record("after PGO", poses_pgo, seconds=pgo_s)

    t0 = time.perf_counter()
    out = run_sfm_from_matches(uvs, dict(pair_matches), K, BA_ITERS, poses_init=poses_pgo,
                               registered_init=sorted(reg), device=dev)
    record("after refine BA", out.poses, out, seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
