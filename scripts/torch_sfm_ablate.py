"""SfM ablation on the card: detect and match once, then compare variants of
``run_sfm_from_matches``; the counterpart of ``scripts/sfm_ablate.py`` for
the port (sift_tpu_torch).

Renders the JAX script's trajectories (``--seqs``: ``sweep-N``, the
there-and-back ``loop-(2 half - 1)`` and the multi-pass ``bigloop-(3 half
- 2)``, ``N = --frames``, a step of 1.6 / max(N, 16)) with
``scripts/torch_sfm_eval.py``'s renderer, detects every frame once
through ``detect_and_describe`` (kernels D and F on the card, float32,
capacities 2048 / 1024 / 2048) and matches every pair of the ``--window``
through ``match_descriptors`` (kernel B).  Then it runs
``run_sfm_from_matches(.., ba_iters=20, verify_pairs=...)`` on those
matches for each of ``--variants`` (pair verification ``off`` / ``on``),
so that an accuracy difference is the SfM stage's and not the detector's.
One JSON line per (sequence, variant): the JAX script's fields (``seq``,
``verify``, ``seconds``, ``points``, ``obs``, ``pruned`` and the
trajectory metrics: ATE-RMSE after similarity alignment, RPE, the path,
ATE % of the path), the frames registered, the kernels' launches in the
sequence's detection and matching (``launches``) and in the variant's run
(``sfm_launches``).

    python scripts/torch_sfm_ablate.py [--frames 16] [--seqs sweep,loop[,bigloop]]
        [--variants off,on] [--window 2] [--device cpu]

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

import chip_smoke as C  # noqa: E402
from sift_tpu_torch import SiftConfig, detect_and_describe, kernels, match_descriptors  # noqa: E402
from sift_tpu_torch.models.sfm import run_sfm_from_matches  # noqa: E402
from sift_tpu_torch.utils.numerics import resolve_device  # noqa: E402

EV = C.port_script("torch_sfm_eval")
K = EV.K
BA_ITERS = EV.BA_ITERS


def sequences(n: int, seqs: str) -> dict:
    """The JAX script's camera positions by name, for the kinds named in
    ``seqs``."""
    base = 1.6 / max(n, 16)
    out = {}
    if "sweep" in seqs:
        out[f"sweep-{n}"] = [f * base for f in range(n)]
    if "loop" in seqs:
        half = max(n // 2, 4)
        out[f"loop-{2 * half - 1}"] = ([f * base for f in range(half)]
                                       + [(half - 2 - f) * base for f in range(half - 1)])
    if "bigloop" in seqs:  # out, back and out again: two revisit passes
        half = max(n // 3, 4)
        out[f"bigloop-{3 * half - 2}"] = ([f * base for f in range(half)]
                                          + [(half - 2 - f) * base for f in range(half - 1)]
                                          + [(f + 1) * base for f in range(half - 1)])
    return out


def detect_and_match(frames, dev, window: int = 2, cfg: SiftConfig | None = None):
    """Every frame's keypoints through the entry point at batch 1, and the
    Lowe matches of every pair (i, j), 0 < j - i <= ``window``, on
    ``dev``: (keypoints, uvs, pair_matches, match_pair), where
    ``match_pair(i, j)`` gives the (M, 2) matches of one more pair."""
    cfg = cfg or SiftConfig(**EV.CAPS)
    kps = [detect_and_describe(f, cfg, device=dev) for f in frames]
    uvs = [torch.stack([kp.x, kp.y], -1).cpu().numpy() for kp in kps]

    def match_pair(i, j):
        idx, acc, _, _ = match_descriptors(kps[i].desc, kps[i].valid, kps[j].desc,
                                           kps[j].valid, cfg.ratio_threshold, device=dev)
        rows = np.nonzero(acc.cpu().numpy())[0]
        return np.stack([rows, idx.cpu().numpy()[rows]], axis=-1)

    pair_matches = {(i, j): match_pair(i, j) for i in range(len(frames) - 1)
                    for j in range(i + 1, min(i + 1 + window, len(frames)))}
    return kps, uvs, pair_matches, match_pair


def run_variant(uvs, pair_matches, variant: str, dev):
    """``run_sfm_from_matches`` with pair verification ``off`` or ``on``."""
    return run_sfm_from_matches(uvs, dict(pair_matches), K, ba_iters=BA_ITERS,
                                verify_pairs=variant == "on", device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--seqs", default="sweep,loop")
    ap.add_argument("--variants", default="off,on")
    ap.add_argument("--window", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    def since(before):
        return {k: n - before[k] for k, n in kernels.launch_counts().items()}

    tex = EV.texture()
    for name, ts in sequences(args.frames, args.seqs).items():
        frames, gt = EV.render_sequence(tex, ts=ts)
        before = kernels.launch_counts()
        _, uvs, pair_matches, _ = detect_and_match(frames, dev, args.window)
        det = since(before)
        for variant in args.variants.split(","):
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            res = run_variant(uvs, pair_matches, variant, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            m = EV._metrics(EV.camera_centers(res.poses), gt)
            m.update(seq=name, verify=variant, seconds=time.perf_counter() - t0,
                     points=res.info["n_points"], obs=res.info["n_obs"],
                     pruned=res.info.get("pruned_obs", 0), frames=len(frames),
                     registered=len(res.info["registered"]), pairs=len(pair_matches),
                     launches=det, sfm_launches=since(before))
            print(json.dumps(m), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
