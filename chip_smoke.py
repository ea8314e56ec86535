#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sift_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sift_tpu_torch/csrc`` (one nvcc per
source, in parallel), holds each kernel against its plain PyTorch version
at the main path's shapes, drives the main path -- batched detect +
describe + match of 640x480 frames, batch 16 (the CAVE-01 pair x8, the
oracle-decoded pixels of tests/data), capacities extrema/kp/ori =
6144/1536/2048 -- and checks the reference's answer on every pair: 677 and
1067 keypoints and the identical 165-match set.  Then it times the sweep,
each stage and each kernel.

Output: one JSON line per phase; then the card's name and power limit as
nvidia-smi reports them, a ``{"kernels": [...]}`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
BATCH = 16
CAPS = dict(extrema_cap=6144, kp_cap=1536, ori_cap=2048)
WANT_KP = (677, 1067)
WANT_MATCHES = 165
TIMED_SWEEPS = 5
KERNEL_REPS = 20
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32
# outside the tensor cores, dense int8 on the tensor cores.
HBM_BPS = 3.35e12
F32_OPS = 67e12
INT8_OPS = 1979e12


class SmokeError(Exception):
    pass


def need(cond, what):
    if not cond:
        raise SmokeError(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not measured"


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events), warm."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def front_bound(shapes, bsz, hks):
    """Least time of the octave fronts of one sweep: each seed read once,
    gauss/DoG/mask/counts written once; float32 operations per pixel from
    the blur taps (mul + r*(add, mul, add) + div per pass, a subtraction
    per DoG) and 26 max + 26 min + abs + compare per mask layer."""
    n = len(hks)
    ops_px = sum(2 * (2 + 3 * (len(hk) - 1)) + 1 for hk in hks) + (n - 2) * 55
    nbytes = ops = 0
    for h, w in shapes:
        nbm = -(-w // 128)
        px = bsz * h * w
        nbytes += 4 * (px * (1 + (n + 1) + n) + bsz * (n - 2) * h * (nbm * 128 + nbm))
        ops += px * ops_px
    return nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3


def front_halo_cost(shapes, hks, tile_h=32, tile_w=128):
    """Cost of kernel A's per-tile halo (csrc/octave_front.cu tiles of
    tile_h x tile_w): (seed elements loaded, blur-pass elements computed),
    each over the minimum of one per pixel, summed over the octaves."""
    radii = [len(hk) - 1 for hk in hks]
    halo = sum(radii) + 1
    loaded = passes = px = 0
    for h, w in shapes:
        px += h * w
        for y0 in range(0, h, tile_h):
            y1 = min(y0 + tile_h, h)
            for x0 in range(0, w, tile_w):
                x1 = min(x0 + tile_w, w)

                def span(lo, hi, n, m):
                    return min(n, hi + m) - max(0, lo - m)

                loaded += span(y0, y1, h, halo) * span(x0, x1, w, halo)
                rem = halo
                for r in radii:
                    passes += span(y0, y1, h, rem) * span(x0, x1, w, rem - r)
                    passes += span(y0, y1, h, rem - r) * span(x0, x1, w, rem - r)
                    rem -= r
    return loaded / px, passes / (2 * len(radii) * px)


def top2_bound(p, n, m):
    ops = 2 * 128 * p * n * m  # multiply + add per byte pair
    nbytes = p * (n + m) * 128 + p * m + 3 * 4 * p * n
    return nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3


def bound(t_bytes, t_ops):
    """(bound_ms, bound_by): the larger of the memory and the operation time."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import sift_tpu_torch  # noqa: F401
        from sift_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    need("jax" not in sys.modules, "the port imported jax")
    from sift_tpu_torch import SiftConfig, match_descriptors
    from sift_tpu_torch.models import sift as S
    from sift_tpu_torch.models.detect import refine_cascade_caps
    from sift_tpu_torch.models.match import ratio_accept
    from sift_tpu_torch.models.pyramid import blur_half_kernels, compute_initial_image
    from sift_tpu_torch.ops.gather import StackSpace
    from sift_tpu_torch.ops.octave_front import octave_front, octave_front_plain
    from sift_tpu_torch.ops.resize import downsample_nearest_x2
    from sift_tpu_torch.ops.top2 import top2, top2_plain

    dev = torch.device("cuda")
    smi = smi_line()

    # -- phase 1: device and kernel build ---------------------------------
    t0 = time.perf_counter()
    logs = kernels.build(["octave_front", "top2"])
    build_s = time.perf_counter() - t0
    # ptxas's register / spill report of each kernel (empty when cached).
    ptxas = {k: [ln.split(":", 1)[-1].strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln] for k, v in logs.items()}
    emit(dict(
        phase="device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), build_s=build_s,
        tf32=torch.backends.cuda.matmul.allow_tf32, ptxas=ptxas,
    ))

    cfg = SiftConfig(**CAPS)
    o1 = np.load(DATA / "oracle_cave00.npz")
    o2 = np.load(DATA / "oracle_cave01.npz")
    frames = np.stack([o1["input"], o2["input"]] * (BATCH // 2))
    imgs = S.as_batch(frames, cfg, dev)
    hks = blur_half_kernels(cfg)
    thr = cfg.extremum_threshold()

    # -- phase 2: kernel A vs its plain version at every octave shape ------
    seeds = [compute_initial_image(imgs, cfg).contiguous()]
    shapes = []
    worst = 0.0
    for o in range(S.octaves_for(imgs, cfg)):
        seed = seeds[-1]
        shapes.append(tuple(seed.shape[1:]))
        ref = octave_front_plain(seed, hks, thr)
        got = octave_front(seed, hks, thr)
        torch.cuda.synchronize()
        for name, a, b in zip(("gauss", "dog", "mask", "counts"), got, ref):
            need(a.shape == b.shape, f"octave {o} {name} shape {a.shape} != {b.shape}")
            if not torch.equal(a, b):
                err = (a.double() - b.double()).abs().max().item()
                raise SmokeError(f"kernel A octave {o} {name}: max |diff| {err}")
        worst = max(worst, (got[0] - ref[0]).abs().max().item())
        down_k = downsample_nearest_x2(got[0][:, got[0].shape[1] - 3])
        down_p = downsample_nearest_x2(ref[0][:, ref[0].shape[1] - 3])
        need(torch.equal(down_k, down_p), f"octave {o} down differs")
        seeds.append(down_p.contiguous())
        del ref, got
    seeds = seeds[: len(shapes)]
    read_x, work_x = front_halo_cost(shapes, hks)
    a_times = front_bound(shapes, BATCH, hks)
    emit(dict(phase="kernel_a_vs_plain", shapes_hw=shapes, batch=BATCH,
              bit_equal=True, max_abs_err=worst, seed_read_factor=read_x,
              blur_work_factor=work_x, bytes_ms=a_times[0], ops_ms=a_times[1]))

    def chain(fn):
        return lambda: [fn(s, hks, thr) for s in seeds]

    a_ms = cuda_ms(chain(octave_front), KERNEL_REPS)
    a_plain_ms = cuda_ms(chain(octave_front_plain), 3)
    a_bound, a_by = bound(*a_times)

    # -- phase 3: kernel B vs its plain version, 8 pairs at 2048 x 2048 -----
    g = torch.Generator().manual_seed(0)
    pairs, n = BATCH // 2, cfg.ori_cap
    d1 = torch.randint(0, 256, (pairs, n, 128), generator=g, dtype=torch.uint8)
    d2 = torch.randint(0, 256, (pairs, n, 128), generator=g, dtype=torch.uint8)
    d2[:, 5] = d1[:, 7]
    d2[:, 1900] = d1[:, 7]  # duplicate best in a later tile: ties
    d2[:, 300] = d2[:, 301]
    v2 = torch.ones((pairs, n), dtype=torch.bool)
    v2[:, 100:140] = False
    v2[:, 1950:] = False  # invalid tail, as in a part-filled buffer
    v2[pairs // 2] = False  # one pair with no valid target
    d1, d2, v2 = d1.to(dev), d2.to(dev), v2.to(dev)
    got = top2(d1, d2, v2)
    ref = top2_plain(d1, d2, v2)
    torch.cuda.synchronize()
    b_err = 0
    for name, a, b in zip(("best", "second", "idx"), got, ref):
        b_err = max(b_err, (a.long() - b.long()).abs().max().item())
        need(torch.equal(a, b), f"kernel B {name} differs from the plain version")
    b_times = top2_bound(pairs, n, n)
    emit(dict(phase="kernel_b_vs_plain", pairs=pairs, n=n, m=n, equal=True,
              bytes_ms=b_times[0], ops_ms=b_times[1]))
    b_ms = cuda_ms(lambda: top2(d1, d2, v2), KERNEL_REPS)
    b_plain_ms = cuda_ms(lambda: top2_plain(d1, d2, v2), 5)
    f1, f2 = d1.float(), d2.float()
    b_lib_ms = cuda_ms(lambda: torch.cdist(f1, f2).topk(2, dim=-1, largest=False), 5)
    b_bound, b_by = bound(*b_times)
    del d1, d2, v2, f1, f2

    # -- phase 4: the main path, counted -----------------------------------
    def sweep():
        kp = S.detect_and_describe_batch(imgs, cfg, device=dev)
        m = match_descriptors(kp.desc[0::2], kp.valid[0::2], kp.desc[1::2],
                              kp.valid[1::2], cfg.ratio_threshold, device=dev)
        return kp, m

    octave_front.launches = top2.launches = 0
    kp, counts = S.detect_and_describe_batch(imgs, cfg, return_counts=True, device=dev)
    idx, acc, _, _ = match_descriptors(kp.desc[0::2], kp.valid[0::2], kp.desc[1::2],
                                       kp.valid[1::2], cfg.ratio_threshold, device=dev)
    torch.cuda.synchronize()
    launches = dict(octave_front=octave_front.launches, top2=top2.launches)
    need(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")

    nkp = kp.valid.sum(1).tolist()
    need(nkp == list(WANT_KP) * (BATCH // 2), f"keypoint counts {nkp}")
    caps = dict(extrema=cfg.extrema_cap, refined=cfg.kp_cap, oriented=cfg.ori_cap)
    for k, cap in caps.items():
        need(int(counts[k].max()) <= cap, f"{k} count {counts[k].tolist()} > cap {cap}")
    for ph, (cap, _) in enumerate(refine_cascade_caps(cfg, cfg.extrema_cap)):
        need(int(counts["refine_active"][:, ph].max()) <= cap, "Newton phase overflow")
    need(int(counts["ori_slots_max"]) <= cfg.ori_cand_slots, "orientation slots overflow")
    for k, v in kp.to_numpy().items():
        if v.dtype.kind == "f":
            need(np.isfinite(v).all(), f"non-finite {k}")

    # Reference match set: the oracle's own descriptors through the plain matcher.
    od1 = torch.from_numpy(o1["final.desc"])[None]
    od2 = torch.from_numpy(o2["final.desc"])[None]
    rb, rs, ri = top2_plain(od1, od2, torch.ones(od2.shape[:2], dtype=torch.bool))
    racc = ratio_accept(rb, rs, torch.ones(od1.shape[:2], dtype=torch.bool))[0]
    want = {(i, int(ri[0, i])) for i in np.nonzero(racc.numpy())[0]}
    need(len(want) == WANT_MATCHES, f"oracle match set has {len(want)}")
    acc_c, idx_c = acc.cpu().numpy(), idx.cpu().numpy()
    for p in range(BATCH // 2):
        got_set = {(i, int(idx_c[p, i])) for i in np.nonzero(acc_c[p])[0]}
        need(got_set == want, f"pair {p}: {len(got_set)} matches, "
             f"{len(got_set ^ want)} differ from the oracle's 165-match set")
    emit(dict(phase="path", keypoints=nkp[:2], matches=WANT_MATCHES,
              same_match_set=True, launches=launches,
              counts={k: v.tolist() for k, v in counts.items()}))

    # -- phase 5: timing of the sweep and its stages ------------------------
    sweep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_SWEEPS):
        sweep()
    torch.cuda.synchronize()
    sweep_s = (time.perf_counter() - t0) / TIMED_SWEEPS

    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t) * 1e3 / TIMED_SWEEPS
        return out

    for _ in range(TIMED_SWEEPS):
        gs, ds, ms_, cs = timed("front", lambda: S.front(imgs, cfg))
        kpr, _ = timed("detect_refine", lambda: S.detect_refine(ds, ms_, cs, cfg))
        del ds, ms_, cs
        gsp = timed("gauss_space", lambda: StackSpace.build(gs))
        del gs
        cand, _ = timed("orient", lambda: S.orient(gsp, kpr, cfg))
        allkp = timed("dedup", lambda: S.dedup(cand, cfg))
        fin = timed("describe", lambda: S.describe(gsp, allkp, cfg))
        del gsp
        timed("match", lambda: match_descriptors(
            fin.desc[0::2], fin.valid[0::2], fin.desc[1::2], fin.valid[1::2],
            cfg.ratio_threshold, device=dev))
    emit(dict(phase="timing", batch=BATCH, frames_per_s=BATCH / sweep_s,
              sweep_ms=sweep_s * 1e3, stage_ms=stages,
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30))

    rows = [
        dict(name="octave_front", route="cuda",
             source="sift_tpu_torch/csrc/octave_front.cu",
             replaces="sift_tpu/ops/pallas_pyramid.py:240",
             launches=launches["octave_front"], max_abs_err=worst,
             ms=a_ms, plain_ms=a_plain_ms, bound_ms=a_bound, bound_by=a_by,
             library_ms=None),
        dict(name="top2", route="cuda", source="sift_tpu_torch/csrc/top2.cu",
             replaces="sift_tpu/ops/pallas_match.py:90",
             launches=launches["top2"], max_abs_err=float(b_err),
             ms=b_ms, plain_ms=b_plain_ms, bound_ms=b_bound, bound_by=b_by,
             library_ms=b_lib_ms),
    ]
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
