"""Spread of incremental SfM over RANSAC streams, the JAX package against the port.

Renders one of ``scripts/torch_sfm_eval.py``'s SfM sequences (sweep-50,
the there-and-back loop-49 or the 97-frame multi-pass loop, from CAVE-01
frame 00) and detects and matches it once,
with the port or (``--detector jax``) with the JAX package as its
``run_sfm`` does (float32, capacities 2048 / 1024 / 2048, match window 2).
Then it runs ``run_sfm_from_matches`` on those matches at several seeds:
the JAX package's (x64 off, as its users run it; on the CPU) and the
port's (on ``--device``).  ``--draws jax`` hands the port the JAX
package's own RANSAC draws, so both run the same hypotheses.

Every RANSAC draw of a run follows from its seed: a frame's PnP takes
seed + frame, a pair (i, j)'s verification seed + 7 i + j; with seeds 100
apart no two runs repeat a draw for the same frame or pair purpose (8 x
12.5 is not an integer).  One JSON line per run: frames registered, the
ones left out, ATE over all frames and over the registered ones
(similarity-aligned, % of the path), the global bundle adjustment's last
RMS reprojection error over the observations it kept, points; then a
summary line per package (mean, SD, median and quartiles of the frames
registered and of the ATE over them).  ``chip_smoke.py``'s reference for
the sweep is the summary of ``--detector jax --packages jax --seeds
0:2100:100``.

    python3 scripts/sfm_stream_spread.py [--sequence sweep-50] [--device cpu]
        [--packages jax,port] [--seeds 100:2200:100] [--detector port] [--draws own]
        [--threads N]

``--sequence``: sweep-50, loop-49 or bigloop-97.  ``--threads N`` runs
the host's work on N threads: the process keeps only the first N of the
CPUs it may use (the JAX package's CPU client sizes its thread pool by
them) and PyTorch's intra-op pool takes N threads.  Float32 reductions on
the host may group differently at another thread count, so the header
line names both packages' counts and a digest of the matches.

The JAX side (``--packages jax``, ``--detector jax``, ``--draws jax``)
needs JAX and runs on the CPU only; ``--packages port --device cuda``
needs a card and no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def detect_and_match(frames, device, detector):
    """Keypoints (uv per frame) and window matches, as ``run_sfm`` makes them:
    with the port's detector and matcher on ``device``, or with the JAX
    package's (``detector="jax"``, x64 off, on the CPU)."""
    if detector == "jax":
        import jax
        import jax.numpy as jnp

        from sift_tpu import SiftConfig, detect_and_describe, match_descriptors

        cfg, ctx, kw, host = (SiftConfig(dtype=jnp.float32, **C.SFM_CAPS),
                              jax.enable_x64(False), {}, np.asarray)
    else:
        from contextlib import nullcontext

        from sift_tpu_torch import SiftConfig, detect_and_describe, match_descriptors

        cfg, ctx, kw = SiftConfig(**C.SFM_CAPS), nullcontext(), dict(device=device)

        def host(x):
            return x.cpu().numpy()
    with ctx:
        kps = [detect_and_describe(f, cfg, **kw) for f in frames]
        uvs = [np.stack([host(kp.x), host(kp.y)], -1) for kp in kps]
        pm = {}
        for i in range(len(frames) - 1):
            for j in range(i + 1, min(i + 1 + C.SFM_WINDOW, len(frames))):
                idx, acc, _, _ = match_descriptors(kps[i].desc, kps[i].valid, kps[j].desc,
                                                   kps[j].valid, cfg.ratio_threshold, **kw)
                rows = np.nonzero(host(acc))[0]
                pm[(i, j)] = np.stack([rows, host(idx)[rows]], -1)
    return uvs, pm


def matches_digest(uvs, pm) -> str:
    """SHA-256 of the keypoints' float32 bytes and the window matches."""
    h = hashlib.sha256()
    for uv in uvs:
        h.update(np.ascontiguousarray(uv, np.float32).tobytes())
    for key in sorted(pm):
        h.update(np.asarray(key, np.int64).tobytes())
        h.update(np.ascontiguousarray(pm[key], np.int64).tobytes())
    return h.hexdigest()


def set_threads(n):
    """Keep the first ``n`` CPUs this process may use and give PyTorch ``n``
    intra-op threads; before the JAX package's first computation, when its
    CPU client sizes its pool by the CPUs it may use."""
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:n])
    torch.set_num_threads(n)


def jax_draws(valid, num_hypotheses, m, seed=0):
    """The (K, m) indices the JAX package's RANSAC functions draw for
    ``seed`` (``jax.random.choice`` with p = valid / valid.sum(), x64 off),
    on ``valid``'s device: a drop-in for the port's ``sample_choice``."""
    import jax
    import jax.numpy as jnp

    v = valid.cpu().numpy()
    with jax.enable_x64(False):
        p = jnp.asarray(v, jnp.float32)
        p = p / jnp.maximum(p.sum(), 1.0)
        idx = jax.random.choice(jax.random.PRNGKey(seed), v.shape[0], shape=(num_hypotheses, m),
                                replace=True, p=p)
    return torch.from_numpy(np.array(idx, np.int64)).to(valid.device)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", default="sweep-50")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--packages", default="jax,port")
    ap.add_argument("--seeds", default="100:2200:100")
    ap.add_argument("--detector", default="port", choices=("port", "jax"))
    ap.add_argument("--draws", default="own", choices=("own", "jax"))
    ap.add_argument("--threads", type=int, default=None,
                    help="host threads for both packages (default: all the process may use)")
    args = ap.parse_args()
    if args.threads:
        set_threads(args.threads)
    device = torch.device(args.device)
    start, stop, step = (int(x) for x in args.seeds.split(":"))
    ev = C.port_script("torch_sfm_eval")
    frames, gt = ev.render_sequence(ev.texture(), ts=ev.sequences(C.SFM_FRAMES)[args.sequence])
    t = time.perf_counter()
    uvs, pm = detect_and_match(frames, device, args.detector)
    print(json.dumps(dict(sequence=args.sequence, device=device.type, detector=args.detector,
                          name=(torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"),
                          nvidia_smi=(C.smi_line() if device.type == "cuda" else None),
                          detect_match_s=time.perf_counter() - t, pairs=len(pm),
                          matches=int(sum(len(m) for m in pm.values())),
                          matches_sha256=matches_digest(uvs, pm),
                          torch_threads=torch.get_num_threads(),
                          host_cpus=len(os.sched_getaffinity(0)),
                          xla_flags=os.environ.get("XLA_FLAGS", ""))), flush=True)
    k = np.array(C.SFM_K)
    runs = {}
    for package in args.packages.split(","):
        if package == "jax":
            import jax

            from sift_tpu.models.sfm import run_sfm_from_matches as jax_run

            def run(seed):
                with jax.enable_x64(False):
                    return jax_run(uvs, dict(pm), k, C.SFM_BA_ITERS, seed=seed)
        else:
            from sift_tpu_torch.models.sfm import run_sfm_from_matches as port_run

            if args.draws == "jax":
                import sift_tpu_torch.models.geometry as PG

                PG.sample_choice = jax_draws

            def run(seed):
                return port_run(uvs, dict(pm), k, C.SFM_BA_ITERS, seed=seed, device=device)
        package += "+jax_draws" if package == "port" and args.draws == "jax" else ""
        runs[package] = []
        for seed in range(start, stop, step):
            t = time.perf_counter()
            res = run(seed)
            secs = time.perf_counter() - t
            reg = res.info["registered"]
            centers = ev.camera_centers(res.poses)
            ba = res.info.get("ba_reprune", res.info["ba"])["cost_trace"][-1]
            kept = res.info["n_obs"] - (res.info["pruned_obs"] if "ba_reprune" in res.info else 0)
            row = dict(package=package, seed=seed, registered=len(reg),
                       unregistered=sorted(set(range(len(frames))) - set(reg)),
                       ate_pct=ev.trajectory_metrics(centers, gt)["ate_pct_of_path"],
                       registered_ate_pct=ev.trajectory_metrics(centers[reg], gt[reg])["ate_pct_of_path"],
                       ba_rms_px=float(np.sqrt(ba / kept)),
                       points=res.info["n_points"], pruned_obs=res.info.get("pruned_obs", 0),
                       seconds=secs)
            runs[package].append(row)
            print(json.dumps(row), flush=True)
    for package, rows in runs.items():
        full = [r for r in rows if r["registered"] == len(frames)]
        print(json.dumps(dict(
            summary=package, detector=args.detector, runs=len(rows), all_registered=len(full),
            all_registered_and_ate_le_2pct=sum(r["ate_pct"] <= 2.0 for r in full),
            min_registered=min(r["registered"] for r in rows),
            first_unregistered=min((r["unregistered"][0] for r in rows if r["unregistered"]),
                                   default=None),
            max_ba_rms_px=max(r["ba_rms_px"] for r in rows),
            registered=C.stream_stats([r["registered"] for r in rows]),
            registered_ate_pct=C.stream_stats([r["registered_ate_pct"] for r in rows]))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
