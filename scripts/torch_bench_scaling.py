"""Scaling efficiency of the port (sift_tpu_torch): frames/s at 1, 2, 4, ...
ranks, the counterpart of ``scripts/bench_scaling.py``.

Data-parallel throughput of the whole detect + describe pipeline over a
``data`` mesh axis: each rank runs ``models/sift.detect_fn`` over its share
of an image batch (the JAX script's ``vmap(detect_fn)`` over a ``data``-
sharded batch; on the card kernels D and H) and the keypoints are gathered
over ``data`` (``parallel/mesh.all_gather``).  The per-rank batch is held
constant (weak scaling), so efficiency(N) = fps(N) / (N * fps(1)).  A size
takes the slowest rank's time of an iteration (CUDA-synchronised wall
clock, the gather included), the least over ``--iters``.  The images are
uniform noise from ``np.random.default_rng(0)``; a size of N ranks takes the
first N * per-device-batch of them, so a frame is the same at every size.

On the card: one rank per card (NCCL; ``parallel/multihost.spawn``), at
every power of two up to the card count; one pool of ranks serves every
size, a size of N ranks on a mesh of ranks 0 .. N-1.  ``--simulate N``
runs N gloo ranks on the CPU instead, which checks the sharded program but
shares the host's cores, so its efficiency reflects overhead, not scaling.

    python scripts/torch_bench_scaling.py [--simulate N] [--per-device-batch 2]
        [--size 480 640] [--iters 10]

Prints one JSON line: the JAX script's ``mode`` and ``scaling`` (devices,
frames_per_s, efficiency), with per size the keypoints of each frame, a
SHA-256 of each frame's valid keypoints (every field), one iteration's
kernel launches on rank 0, and any count above its capacity (``clipped``).
Runs on the card unless ``--simulate`` (the script's only CPU switch, as in
the JAX script); without a card it raises.
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
import torch.distributed as dist  # noqa: E402

from sift_tpu_torch import SiftConfig, kernels  # noqa: E402
from sift_tpu_torch.bench import device_line  # noqa: E402
from sift_tpu_torch.models.sift import clipped, detect_fn  # noqa: E402
from sift_tpu_torch.parallel.mesh import all_gather, axis_index, make_mesh, mesh_device  # noqa: E402
from sift_tpu_torch.parallel.multihost import spawn  # noqa: E402
from sift_tpu_torch.utils.keypoints import FIELDS, Keypoints  # noqa: E402
from sift_tpu_torch.utils.numerics import resolve_device  # noqa: E402


def config_for(h: int, w: int) -> SiftConfig:
    """The JAX script's capacities for an h x w frame, float32."""
    small = max(h, w) <= 256
    return SiftConfig(extrema_cap=256 if small else 2048, kp_cap=128 if small else 1024,
                      ori_cap=512 if small else 2048)


def images(n: int, h: int, w: int) -> np.ndarray:
    """The first ``n`` frames: (n, h, w, 3) float32 uniform in [0, 255)."""
    return np.random.default_rng(0).uniform(0, 255, (n, h, w, 3)).astype(np.float32)


def keypoints_digest(kp: Keypoints) -> str:
    """SHA-256 of one frame's valid keypoints, every field's bytes."""
    valid = kp.valid.cpu().numpy()
    h = hashlib.sha256()
    for f in FIELDS:
        h.update(np.ascontiguousarray(getattr(kp, f).cpu().numpy()[valid]).tobytes())
    return h.hexdigest()


def sizes_upto(n: int) -> list[int]:
    return [s for s in (1, 2, 4, 8, 16, 32) if s <= n]


def _rank(sizes, per_device_batch, h, w, iters, device):
    """One rank's part of every size: per size its iterations' seconds and,
    on the size's mesh, the clipped counts of its share; rank 0 adds the
    gathered keypoints' digests and counts and one iteration's launches."""
    cfg = config_for(h, w)
    octaves = cfg.octaves_count(w * 2, h * 2)
    imgs = images(max(sizes) * per_device_batch, h, w)
    out = []
    for n in sizes:
        mesh = make_mesh(data=n, kp=1, device=device, ranks=range(n))
        if mesh.get_coordinate() is None:
            out.append(None)
            continue
        dev = mesh_device(mesh)
        i = axis_index(mesh, "data")
        share = imgs[i * per_device_batch:(i + 1) * per_device_batch]
        bsz = n * per_device_batch

        def step(counts=None):
            kps = []
            for im in share:
                got = detect_fn(im, cfg, octaves, device=dev, return_counts=counts is not None)
                if counts is not None:
                    got, c = got
                    counts.append(c)
                kps.append(got)
            kp = Keypoints(**{f: torch.stack([getattr(k, f) for k in kps]) for f in FIELDS})
            return kp.map(lambda a: all_gather(a, mesh, "data").reshape(bsz, *a.shape[1:]))

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        kernels.reset_launch_counts()
        counts = []
        kp = step(counts)
        sync()
        rec = dict(launches=kernels.launch_counts(),
                   clipped=[c for f, cs in enumerate(counts)
                            for c in clipped(cs, cfg, first=i * per_device_batch + f)])
        times = []
        for _ in range(iters):
            dist.barrier(group=mesh.get_group("data"))
            sync()
            t = time.perf_counter()
            step()
            sync()
            times.append(time.perf_counter() - t)
        rec["seconds"] = times
        if i == 0:
            frames = [kp.map(lambda a, f=f: a[f]) for f in range(bsz)]
            rec.update(keypoints=[int(k.valid.sum()) for k in frames],
                       keypoints_sha256=[keypoints_digest(k) for k in frames])
        out.append(rec)
    return out


def scaling(n_ranks: int, per_device_batch: int, h: int, w: int, iters: int, device) -> dict:
    """The JSON line of sizes 1, 2, 4, ... up to ``n_ranks`` ranks on
    ``device`` (cuda: one rank per card, NCCL; cpu: gloo)."""
    dev = resolve_device(device)
    sizes = sizes_upto(n_ranks)
    per_rank = spawn(_rank, max(sizes), args=(sizes, per_device_batch, h, w, iters, dev.type),
                     device=dev.type)
    table, bad = [], []
    for k, n in enumerate(sizes):
        recs = [r[k] for r in per_rank[:n]]
        # An iteration lasts as long as its slowest rank.
        seconds = min(max(r["seconds"][t] for r in recs) for t in range(iters))
        bad += [c for r in recs for c in r["clipped"]]
        table.append(dict(devices=n, frames_per_s=n * per_device_batch / seconds,
                          keypoints=recs[0]["keypoints"],
                          keypoints_sha256=recs[0]["keypoints_sha256"],
                          launches=recs[0]["launches"]))
    base = table[0]["frames_per_s"]
    for row in table:
        row["efficiency"] = row["frames_per_s"] / (row["devices"] * base)
    return dict(mode="cuda" if dev.type == "cuda" else "simulated-cpu", scaling=table,
                clipped=bad, size=[h, w], per_device_batch=per_device_batch, iters=iters,
                device=device_line(torch.device("cuda", 0)) if dev.type == "cuda" else "cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--simulate", type=int, default=0,
                    help="N gloo ranks on the CPU (validation, not performance)")
    ap.add_argument("--per-device-batch", type=int, default=2)
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if args.simulate:
        n, device = args.simulate, "cpu"
    else:
        resolve_device("cuda")
        n, device = torch.cuda.device_count(), "cuda"
    h, w = args.size
    print(json.dumps(scaling(n, args.per_device_batch, h, w, args.iters, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
