#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sift_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sift_tpu_torch/csrc`` (one nvcc per
source, in parallel) and holds each kernel against its plain PyTorch
version at the shapes its paths give it: kernel A (octave front), B (top-2
matcher; 8 pairs of 2048 x 2048 and one of 1286 x 1430, with planted
ties), C (octave blur), D (one separable blur, one launch; ptxas must
report no stack frame and no spills), E (twin-row gather space), F
(octave front into the front-twin gather layouts), G (cube-packed DoG
rows), H (row-major twin rows), I (descriptors) and J (detect + refine;
I and J at the benchmark cells' shapes, J bit for bit against its plain
chain); E and H (one launch a gather space)
also through their launcher into NaN-filled buffers, so that a row the
launch does not write fails, at the sweep's, the staged path's and the
demo pair's shapes, blk 64 and 128, and G the same way at the batch's,
the demo pair's and the wide frames' DoG stacks.  Then it drives the port's routes on
640x480 frames (the CAVE-01 pair, the oracle-decoded pixels of
tests/data), capacities extrema/kp/ori = 6144/1536/2048, float32:

* the main path, the front-twin route: batched detect + describe + match,
  batch 16 (the pair x8), through kernels D (initial image), F and B;
* the same route with two octaves sent through its fallback (kernels A
  and G beside F);
* (phase ``wide_fallback``) two wide frames, CAVE-01 scene frames 00-15
  and 01-16 set side by side (480 x 10,240, doubled to 960 x 20,480),
  batch 2, capacities 131,072 / 24,576 / 32,768, through the entry point:
  octave 0 is wider than kernel F takes, so the plan sends it, and only
  it, through the fallback (A 1, G 1, F 7, D 1, B 1 with the matcher);
  bit-equal to the front route (match set included), both gather buffers
  and the route's outputs bit-equal to octave 0 forced through kernel F at
  strip 128, kernel G on the wide stack into a NaN-filled buffer against
  its plain version; the sweeps in turns beside the front route's, the
  fallback octave's pieces (A, ``twin_strided`` and its copy, G) by CUDA
  events beside their bounds, peak memory;
* the front route (plain stacks) through ``run_route``: D, A, B;
* the staged path ``detect_stages``, frame by frame, through C, D and H;
* the non-front (XLA) route with ``use_octave_kernel=False``, batch 16,
  through D for the initial image and every blur of the chain, and E for
  the DoG and gauss gather spaces;

and checks the reference's answer on each: 677 and 1067 keypoints and the
identical 165-match set on every pair, and the same keypoints and
descriptors as the main path.  Then the non-front route as a
``window_size=5`` configuration takes it, batch 16, through C, D, E and
B: finite, within its capacities, and equal to the same route on the
plain stacks.  Then the demo pair (755 x 499, doubled to 1510 x 998),
batch 2, through the main path, the fallback, the front route, the XLA
route and the staged path: each bit-equal to the main path, finite and
within its capacities, with kernels D and B held against their plain
versions at the demo's shapes; it prints whether the float32 run holds the
anchor (1286 / 1430 keypoints, 269 matches), which the CPU tests hold in
float64.  Then the pair CLI on the CAVE 00 / 01 frames written as PNG,
in this process (``cli.main``, counted: D, F, B) and as the command a
user runs (``python -m sift_tpu_torch a.png b.png --json``): 677 / 1067
keypoints, 165 matches, three PNGs.  Then stitching (phase ``stitch``):
the 35-frame CAVE-01 scene (tests/data/scene_oracle) written as PNG, no
graph file, so the chain graph centred at 17, default capacities, through
``python -m sift_tpu_torch stitch`` in this process (counted: D 35, F 35
x octaves, B 34) and as a subprocess; the same scene at library level
(keypoints per frame against the oracle's, 677 / 1067 on frames 00 / 01,
chain-edge matches against PARITY.md's float64 counts, 165 on edge 0-1,
RANSAC inliers, canvas, which blend ran, a finite panorama in [0, 255],
the detection, edge solve and composite timed); frames 00-04 on the card
against the CPU on the same keypoints and hypotheses (corners within 0.05
px, 99.5% of pixels within 1 grey level); a planted RANSAC tie; and the
cylindrical driver on three crops of frame 05 within the JAX test's
bounds.  Then the port's evaluation tools as a user runs them (phase
``tools``): ``scripts/torch_verify_scene_parity.py`` at the scene's
capacities with ``--provenance`` (the bench-capacity anchor, the exact
165-match set; every frame's keypoints and every chain edge's matches
equal to the stitch phase's; every differing match of a non-exact edge
classified), ``scripts/torch_sfm_eval.py --frames 8`` (its four lines and
its table; all 8 frames of the sweep registered) and
``scripts/torch_bench_scaling.py`` at world size 1 (a well-formed line,
nothing clipped, frame 0's keypoints bit-equal to a direct ``detect_fn``
call, kernels D and H launched), and the counterparts of the JAX
package's last four tools (``jax_tool_scripts``):
``scripts/torch_bench_match_ab.py --reps 5`` (kernel B at 2048-32768
descriptors a side, bit-equal to its plain version wherever that ran, an
OOM the only failure allowed off the kernel path),
``scripts/torch_perf_breakdown.py --reps 5 --out FILE`` (every row of the
JAX script at ``SiftConfig()``'s capacities, the stage chain bit-equal to
the entry point, A, B, C, D, E and F launched),
``scripts/torch_sfm_ablate.py`` (sweep-16 and loop-15, verification off
and on; D and F for every frame, B for every pair) and
``scripts/torch_sfm_pgo_debug.py`` (the 97-frame loop's base, after-PGO
and after-refine-BA metrics, a closure, the refine BA registering at
least the base's frames).  Then incremental SfM: kernels D, F and
B against their plain versions at its shapes (phase
``sfm_kernels_vs_plain``), and (phase ``sfm``) ``run_sfm`` on the card
on the JAX package's rendered evaluation sequences (rendered and measured
by ``scripts/torch_sfm_eval.py``'s functions), sweep-50 and the 97-frame
multi-pass loop (320x240 from CAVE-01 frame 00; counted: D and F for
every frame, B for every matched pair), each run again with its stages
timed; the loop gated on registered frames, ATE and the loop-closure
repair, the sweep over 21 RANSAC streams against the JAX package's own
spread, both on the bundle adjustment's residual; and the JAX test's
6-frame sequence twice on the card (bit-equal) and once on the CPU (the same frames and initial pair,
centres within 1% of the span).  Then the multi-device layer (phase
``parallel``, ``sift_tpu_torch/parallel``): one pool of four spawned ranks
that share the card through gloo runs, each call counted per rank
(``multihost.run_steps``), ``batched_detect`` of the batch over a (data
2, kp 2) mesh (bit-equal to the main path's batch: D 1, F 8 a rank),
``sharded_match`` of its pairs at kp 2 and 4 (bit-equal to
``match_descriptors``, the 165-match set; B 1 a call), the row-sharded
``spatial_detect_and_describe`` of CAVE 00 (against ``detect_stages``
under the JAX test's tolerances; C 8, D 1, H 24 a rank), the point-sharded
``sharded_ba_solve`` of a 97-camera, 20,000-point problem (against
``ba_solve``), and the elastic recovery on a mesh of ranks {0, 1}; then
NCCL at world size 1 in this process; D, F, B, C and H held against their
plain versions at these shapes.  Every launch counter is set to 0 just
before a path and read just after.  Then it times the sweeps, each
stage, the staged path and the other routes; then the radius classes of
orientation and descriptors (phase ``radius_classes``) against the
worst-case window on the main path's buffers, in turns: lanes per class,
the two stages' and the stage-by-stage sweep's ms, and the outputs
compared (the same candidates; descriptor bytes that differ printed);
then each kernel, beside its library yardstick where there is one (B:
``cdist`` + ``topk``; D: cuDNN convolutions; E, G, H: ``copy_`` from an
overlapping ``as_strided`` view of the padded input).  Last, the streaming
path (phase ``stream``, ``stream_phase``): the 35 scene frames as PNG
through the native threaded loader (in order, bit-equal, a missing path
raising at its position), ``as_batch``'s host-to-card bytes from a
profiler trace, the pair x8 as a pinned uint8 card tensor against the
float32 main path, the honesty scan at the bench's stream capacities (and
what ``bench.py``'s capacities clip), the scene streamed from disk against the
frames in memory (counted: D, F, B), ``pairwise_sq_dists`` against the
exact integers and kernel B, and ``python -m sift_tpu_torch.bench`` and
``scripts/torch_scene_throughput.py`` as a user runs them.

Output: one JSON line per phase; then the card's name and power limit as
nvidia-smi reports them, a ``{"kernels": [...]}`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
BATCH = 16
CAPS = dict(extrema_cap=6144, kp_cap=1536, ori_cap=2048)
WANT_KP = (677, 1067)
WANT_MATCHES = 165
DEMO_KP = (1286, 1430)  # the demo pair's anchor (oracle_demo{1,2}.npz)
DEMO_MATCHES = 269
DEMO_CAPS = dict(extrema_cap=8192, kp_cap=2048, ori_cap=2048)
# The CAVE-01 scene (tests/data/scene_oracle): 35 frames, the chain graph
# (i, i + 1) centred at 17, and the float64 match counts of its 34 chain
# edges in the reference's direction (i -> i + 1; PARITY.md, whole-scene
# audit).
SCENE_FRAMES = 35
CHAIN_MATCHES_F64 = (165, 251, 119, 188, 170, 197, 260, 294, 153, 111, 129, 138, 194, 185,
                     160, 109, 108, 115, 58, 43, 173, 68, 109, 82, 72, 173, 141, 102, 79, 44,
                     126, 73, 146, 179)
CYL_CAPS = dict(extrema_cap=1024, kp_cap=512, ori_cap=2048)
# The default capacities' Newton cascade keeps n // 4 = 2048 lanes after
# step 1 (models/detect.refine_cascade_caps); the scene needs more (frame
# 12: 2226), so the library-level scene runs with extrema_cap 12288
# (cascade 3072 / 1536) beside the defaults that the command uses.
SCENE_CAPS = dict(extrema_cap=12288)
# The SfM phase: the JAX package's evaluation (scripts/sfm_eval.py:90-140)
# at its full size, the frames rendered from CAVE-01 frame 00 (the oracle's
# decoded pixels): a 50-frame lateral sweep and the 97-frame multi-pass
# loop (three segments of 33, 32 and 32 frames), 320x240, fx 300, its
# capacities, match window 2, 20 BA iterations.
SFM_FRAMES = 50
SFM_CAPS = dict(extrema_cap=2048, kp_cap=1024, ori_cap=2048)
SFM_K = ((300.0, 0.0, 160.0), (0.0, 300.0, 120.0), (0.0, 0.0, 1.0))
SFM_BA_ITERS = 20
SFM_WINDOW = 2
# Gates.  bigloop-97, as asked of the slice: the repair ran, at least 85 of
# 97 frames registered, ATE at most 3% of the path.  sweep-50 runs no
# repair, and its outcome follows the RANSAC stream, for the JAX package as
# for the port: a stream is chaotic (the port fed the JAX package's own
# draws on its matches parts from it within a few frames).  The JAX
# package's whole pipeline (its detector, matcher and run_sfm_from_matches,
# x64 off, on the CPU: ``scripts/sfm_stream_spread.py --detector jax
# --packages jax --seeds 0:2100:100``) registers all 50 frames at ATE <= 2%
# in 6 of 21 streams, 32-50 frames with 0.93-10.52% ATE over them; SFM.md's
# 0.84% is one stream.  So sweep-50 is gated as a distribution: on the card,
# ``run_sfm_from_matches`` on the sweep's own matches at the same 21 seeds
# must register on average no fewer frames than the reference less two
# standard errors of the difference of the means, and its median ATE over
# the registered frames must be at most the reference's upper quartile.
# SFM_REFERENCE is that run's summary line.  Both sequences: every pose
# and point finite, and the global bundle adjustment's last solve at most
# 1 px RMS of reprojection error over the observations it kept.
SFM_GATES = {"bigloop-97": dict(min_registered=85, max_ate_pct=3.0)}
SFM_STREAM_SEEDS = range(0, 2100, 100)
SFM_REFERENCE = dict(
    registered=dict(n=21, mean=46.76190476190476, sd=4.624983912455932, min=32.0, q1=45.0,
                    median=49.0, q3=50.0, max=50.0),
    registered_ate_pct=dict(n=21, mean=3.164255657217081, sd=2.6678220292014094,
                            min=0.9317280116059801, q1=1.6549308940181857,
                            median=2.3605497536930704, q3=2.750845421624865,
                            max=10.519942265338372),
    all_registered_and_ate_within_2pct=6)
SFM_MAX_BA_RMS_PX = 1.0
# The card against the CPU on the JAX test's 6-frame sequence
# (tests/test_sfm_images.py:61-71): camera centres within this fraction of
# the span after similarity alignment.
SFM_CARD_CPU_TOL = 0.01
# The parallel phase: ranks sharing the card through gloo, and its BA
# problem (``chain_ba_scene``): as many cameras as bigloop-97, 20,000
# points, the SfM phase's intrinsics, tests/test_ba_dist.py's 12 iterations.
PAR_RANKS = 4
PAR_BA_CAMS = 97
PAR_BA_POINTS = 20000
PAR_BA_FXY = (300.0, 300.0)
PAR_BA_CXY = (160.0, 120.0)
PAR_BA_ITERS = 12
# Phase ``wide_fallback``: two wide frames, each CAVE-01 scene frames set
# side by side (00-15 and 01-16: 480 x 10,240, doubled to 960 x 20,480),
# batch 2, nothing cut.  Octave 0 is wider than kernel F takes (19,328
# columns), so the entry point sends it through the fallback (kernels A
# and G).  Capacities: kp / ori 16x the main path's; extrema 131,072, since
# at 16x (98,304) the Newton cascade's first phase (extrema_cap / 4 lanes)
# clipped 24,725 and 25,502 lanes (NVIDIA H100, float32).
WIDE_FRAMES = 16
WIDE_CAPS = dict(extrema_cap=131072, kp_cap=24576, ori_cap=32768)
WIDE_PLAN0 = (128, 931)  # octave 0's strip and packed blocks a row
WIDE_SWEEPS = 2
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


def host_ms(fn, reps: int) -> float:
    """Mean host time of ``fn`` over ``reps`` synchronised runs, warm."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed (CUDA events around the replay), so that the host's
    pace of launching through a Python wrapper is out of the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, 5) / reps
    del graph
    return ms


def blur_ops(hk) -> int:
    """float32 operations per pixel of one separable blur: mul + r*(add,
    mul, add) + div per pass, two passes."""
    return 2 * (2 + 3 * (len(hk) - 1))


def octave_bound(shapes, bsz, hks, mask: bool):
    """Least time of one sweep's octaves, kernel A (``mask``) or C: each
    seed read once, gauss/DoG (A: and mask/counts) written once; float32
    operations per pixel from the blur taps, a subtraction per DoG (A: and
    26 max + 26 min + abs + compare per mask layer)."""
    n = len(hks)
    ops_px = sum(blur_ops(hk) + 1 for hk in hks) + (n - 2) * 55 * mask
    nbytes = ops = 0
    for h, w in shapes:
        nbm = -(-w // 128)
        px = bsz * h * w
        nbytes += 4 * px * (1 + (n + 1) + n)
        if mask:
            nbytes += 4 * bsz * (n - 2) * h * (nbm * 128 + nbm)
        ops += px * ops_px
    return nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3


def blur_bound(shape, hk):
    """Least time of one blur of a (B, H, W) float32 plane: the input read
    once and the output written once (kernel D's one pass)."""
    px = math.prod(shape)
    return 8 * px / HBM_BPS * 1e3, px * blur_ops(hk) / F32_OPS * 1e3


def front_halo_cost(shapes, hks, bsz, mask: bool):
    """Cost of the halo of csrc/octave_front.cu's rolling row window (tile
    width, strip rule and halos from ops/octave_rolling.py, which mirrors the
    source's constants): (seed elements loaded, blur-pass elements computed),
    each over the minimum of one per pixel, summed over the octaves; and the
    strip rows and CTAs of each octave.  A CTA loads and computes, per layer,
    the rows of its strip plus that layer's warm-up rows on both sides, and
    the tile's columns plus that layer's halo."""
    from sift_tpu_torch.ops.octave_rolling import TILE_W, layer_ext, row_ranges, strip_rows_for

    radii = [len(hk) - 1 for hk in hks]
    ext = layer_ext(radii, mask)
    loaded = passes = px = 0
    strips, ctas = [], []
    for h, w in shapes:
        px += h * w
        strip = strip_rows_for(bsz, h, w, ext[0])
        strips.append(strip)
        ctas.append(-(-h // strip) * -(-w // TILE_W) * bsz)
        for ys in range(0, h, strip):
            rng = row_ranges(ys, min(ys + strip, h), h, ext)
            for x0 in range(0, w, TILE_W):
                tw = min(x0 + TILE_W, w) - x0
                loaded += (rng[0][1] - rng[0][0]) * (tw + 2 * ext[0])
                for k in range(1, len(ext)):
                    wide = tw + 2 * ext[k]
                    passes += (rng[k - 1][1] - rng[k - 1][0]) * wide  # horizontal
                    passes += (rng[k][1] - rng[k][0]) * wide          # vertical
    return loaded / px, passes / (2 * len(radii) * px), strips, ctas


def top2_bound(p, n, m):
    ops = 2 * 128 * p * n * m  # multiply + add per byte pair
    nbytes = p * (n + m) * 128 + p * m + 3 * 4 * p * n
    return nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3


def planted_top2(p, n, m, seed=0):
    """Random (desc1, desc2, valid2) for kernel B with ties planted where its
    scan could get them wrong: two columns of one lane and of two lanes of
    one 8-column fragment, across 128-column tiles and across the column
    splits, the same tie for rows of two warps, two equal targets; invalid
    runs, an invalid tail with one valid column at its end, and (p > 1) a
    pair with no valid target."""
    import torch

    g = torch.Generator().manual_seed(seed)
    d1 = torch.randint(0, 256, (p, n, 128), generator=g, dtype=torch.uint8)
    d2 = torch.randint(0, 256, (p, m, 128), generator=g, dtype=torch.uint8)
    if n > 30:
        d1[:, 30] = d1[:, 7]  # rows of warps 0 and 1 with the same ties
    plant = [(7, [2, 3]), (8, [1, 6]), (20, [5, 130]), (40, [299, m - 1]),
             (63, [64, 64 + 128 * 2]), (n - 1, [m // 2, m // 2 + 1])]
    for row, cols in plant:
        for c in cols:
            if row < n and 0 <= c < m:
                d2[:, c] = d1[:, row]
    if m > 301:
        d2[:, 300] = d2[:, 301]  # equal targets: equal distances for every row
    v2 = torch.ones((p, m), dtype=torch.bool)
    v2[:, 100:140] = False
    if m:
        v2[:, m - m // 20:] = False
        v2[:, m - 1] = True
    if p > 1:
        v2[p // 2] = False
    return d1, d2, v2


def bound(t_bytes, t_ops):
    """(bound_ms, bound_by): the larger of the memory and the operation time."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same(a, b, what: str) -> float:
    """Fail unless ``a`` and ``b`` are equal in shape and bits; returns the
    max |a - b| as measured (0.0 when they are equal)."""
    need(a.shape == b.shape, f"{what}: shape {tuple(a.shape)} != {tuple(b.shape)}")
    err = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
    need(err == 0.0 and bool((a == b).all()), f"{what}: max |diff| {err}")
    return err


def twin_bound(floats_in, floats_out):
    """Least time of kernel E's gather spaces: every stack read once and
    each whole (B, RT, 2 blk) buffer written once; no arithmetic."""
    return 4 * (floats_in + floats_out) / HBM_BPS * 1e3, 0.0


def check_twin_launch(stacks, blk, what) -> float:
    """Kernel E through its launcher into a NaN-filled buffer, against the
    plain version over the whole buffer (gaps and strip padding included):
    a row the launch does not write stays NaN and fails."""
    import torch

    from sift_tpu_torch.ops import twin_rows as TR

    bsz = stacks[0].shape[0]
    table = TR.strips_table(tuple(tuple(v.shape[1:]) for v in stacks), blk)
    buf = torch.full((bsz, table.rows, 2 * blk), float("nan"), device=stacks[0].device)
    TR.launch(table, stacks, buf)
    return same(buf, TR.twin_rows_strips_plain(stacks, blk).rows,
                f"{what} blk {blk}, NaN-filled buffer, vs plain")


def check_rows_launch(vols, blk, what) -> float:
    """Kernel H the same way: the volumes' row-major rows, one launch."""
    import torch

    from sift_tpu_torch.ops import twin_rows as TR

    table = TR.rows_table(tuple(v.shape for v in vols), blk)
    buf = torch.full((1, table.rows, 2 * blk), float("nan"), device=vols[0].device)
    TR.launch(table, vols, buf)
    ref = torch.cat([TR.twin_rows_2d_plain(v.reshape(-1, v.shape[-1]), blk) for v in vols])
    return same(buf[0], ref, f"{what} blk {blk}, NaN-filled buffer, vs plain")


def twin_padded(stacks, blk):
    """The untimed part of kernel E's yardstick: each octave's flat rows
    padded with zeros to (nb + 1) * blk columns and to whole strips."""
    import torch.nn.functional as F

    from sift_tpu_torch.ops.twin_rows import plan

    metas, total = plan(tuple(tuple(v.shape[1:]) for v in stacks), blk)
    pads = [F.pad(v.reshape(v.shape[0], -1, v.shape[-1]),
                  (0, (nb + 1) * blk - v.shape[-1], 0, rpad - v.shape[1] * v.shape[2]))
            for v, (nb, _, rpad, _) in zip(stacks, metas)]
    return pads, metas, total


def library_twin(pads, metas, total, blk):
    """The yardstick for kernel E, never called by the port: per octave one
    ``copy_`` from an overlapping ``as_strided`` view of its padded rows
    into the view of its region, and a ``zero_`` per alignment gap."""
    import torch

    bsz = pads[0].shape[0]
    rows = torch.empty((bsz, total, 2 * blk), device=pads[0].device)
    end = 0
    for p, (nb, ls, rpad, base) in zip(pads, metas):
        if base > end:
            rows[:, end:base].zero_()
        st, wp = 1 << ls, (nb + 1) * blk
        rows[:, base: base + nb * rpad].view(bsz, rpad // st, nb, st, 2 * blk).copy_(
            p.as_strided((bsz, rpad // st, nb, st, 2 * blk), (rpad * wp, st * wp, blk, wp, 1)))
        end = base + nb * rpad
    return rows


def library_rows(pads, blk):
    """The yardstick for kernel H: per volume one ``copy_`` from an
    overlapping ``as_strided`` view of its rows padded to (nb + 1) * blk
    columns into the view of its rows."""
    import torch

    total = sum(p.shape[0] * (p.shape[1] // blk - 1) for p in pads)
    rows = torch.empty((total, 2 * blk), device=pads[0].device)
    base = 0
    for p in pads:
        r, wp = p.shape
        nb = wp // blk - 1
        rows[base: base + r * nb].view(r, nb, 2 * blk).copy_(
            p.as_strided((r, nb, 2 * blk), (wp, blk, 1)))
        base += r * nb
    return rows


def cube_padded(d, strip):
    """The untimed part of kernel G's yardstick: the DoG stack with one zero
    column before and enough after for every window, and rows to a whole
    strip (``gather.cube_rows_plain``'s padding)."""
    import torch.nn.functional as F

    from sift_tpu_torch.ops.gather import cube_rows_params

    _, s, h, w = d.shape
    stride, sw, nbp = cube_rows_params(s, w)
    return F.pad(d, (1, (nbp - 1) * stride + sw - 1 - w, 0, -(-h // strip) * strip - h))


def library_cube(dp, strip, out, base):
    """The yardstick for kernel G: one ``copy_`` from an overlapping
    ``as_strided`` view of the padded stack into the lanes [0, S * sw) of
    the octave's 128-lane rows from ``base`` (the other lanes are not
    written)."""
    from sift_tpu_torch.ops.gather import cube_rows_params

    b, s, hp, wp = dp.shape
    stride, sw, _ = cube_rows_params(s, wp)
    nbp = (wp - sw) // stride + 1
    nstr = hp // strip
    dst = out[:, base: base + nstr * nbp * strip].view(b, nstr, nbp, strip, 128)
    dst[..., : s * sw].unflatten(-1, (s, sw)).copy_(dp.as_strided(
        (b, nstr, nbp, strip, s, sw), (s * hp * wp, strip * wp, stride, wp, hp * wp, 1)))
    return out


def check_cube_launch(stacks, strips, bases, total, what, pack=None) -> float:
    """Kernel G at each octave's base of one NaN-filled (B, total, 128)
    buffer, against the plain version on each octave's region; every row
    outside the regions (alignment gaps, later octaves) must stay NaN.
    ``pack(d, strip, out, base)``: the launch, ``cube_pack_rows`` unless
    given (scripts/ab_cube_pack.py passes an earlier version's)."""
    import torch

    from sift_tpu_torch.ops.cube_pack import cube_pack_rows
    from sift_tpu_torch.ops.gather import cube_rows_plain

    buf = torch.full((stacks[0].shape[0], total, 128), float("nan"), device=stacks[0].device)
    inside = torch.zeros(total, dtype=torch.bool, device=buf.device)
    err = 0.0
    for o, (d, st, pb) in enumerate(zip(stacks, strips, bases)):
        if pack is None:
            cube_pack_rows(d, st, out=buf, base=pb)
        else:
            pack(d, st, buf, pb)
        ref = cube_rows_plain(d, st)
        err = max(err, same(buf[:, pb: pb + ref.shape[1]], ref,
                            f"{what} octave {o}, NaN-filled buffer, vs plain"))
        inside[pb: pb + ref.shape[1]] = True
        del ref
    need(bool(torch.isnan(buf[:, ~inside]).all()), f"{what}: a row outside the regions written")
    return err


def front_twin_bound(plan, bsz, hks):
    """Least time of one sweep's octaves through kernel F, counting what its
    launch moves: each seed read once; every value it stores into the two
    gather buffers (csrc/octave_front.cu ``twin_put``: a gauss value of a
    stored layer once, and once more from column blk on; ``packed_put``:
    a DoG value in its block, and in the block before where the windows
    overlap), mask, counts and ``down`` written once; kernel A's float32
    operations.  The buffers' zero lanes, rows past H and gaps come from
    their zero fill, which is no part of the launch and is timed apart."""
    n = len(hks)
    ops_px = sum(blur_ops(hk) + 1 for hk in hks) + (n - 2) * 55
    sw = 128 // n
    stride = sw - 3
    nbytes = ops = 0
    for (h, w, _, _, _, _), nbp in zip(plan.octaves, plan.pk_nbps):
        nbm = -(-w // 128)
        twin = w + max(w - plan.blk, 0)
        packed = 0
        for x in range(w):
            cb, j = divmod(x + 1, stride)
            packed += (cb < nbp) + (1 <= cb <= nbp and j + stride < sw)
        floats = h * w + h * (plan.g_nl * twin + n * packed)
        floats += (n - 2) * h * (nbm * 128 + nbm) + h * w
        nbytes += 4 * bsz * floats
        ops += bsz * h * w * ops_px
    return nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3


def library_blur(img, hk):
    """The yardstick for kernel D, never called by the port: one blur as
    replicate padding and a 1-D cuDNN convolution per axis, taps divided by
    sum_w, in full float32 (sift_tpu_torch turns TF32 off at import)."""
    import torch
    import torch.nn.functional as F

    from sift_tpu_torch.config import half_kernel_weight_sum

    r = len(hk) - 1
    full = torch.tensor(hk[::-1] + hk[1:], dtype=torch.float64) / half_kernel_weight_sum(hk)
    full = full.to(device=img.device, dtype=torch.float32)
    x = F.conv2d(F.pad(img[:, None], (r, r, 0, 0), mode="replicate"), full.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), full.view(1, 1, -1, 1))
    return x[:, 0]


@functools.cache
def port_script(name):
    """``scripts/<name>.py`` as a module, loaded once (the port's scripts
    import only torch, numpy and the port)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sfm_sequences(n=SFM_FRAMES):
    """scripts/sfm_eval.py's sweep-n and multi-pass loop camera positions
    (``scripts/torch_sfm_eval.sequences``)."""
    return {k: v for k, v in port_script("torch_sfm_eval").sequences(n).items()
            if not k.startswith("loop-")}


def stream_stats(values) -> dict:
    """Mean, SD (ddof 1), extremes and quartiles (numpy's linear rule) of
    one quantity over RANSAC streams."""
    import numpy as np

    v = np.asarray(values, np.float64)
    q1, med, q3 = np.percentile(v, [25, 50, 75])
    return dict(n=len(v), mean=float(v.mean()), sd=float(v.std(ddof=1)), min=float(v.min()),
                q1=float(q1), median=float(med), q3=float(q3), max=float(v.max()))


def sfm_phase(dev, smi, zero_counts, read_counts, octaves_of):
    """Phase ``sfm``: ``run_sfm`` on the card on sweep-50 and bigloop-97,
    each run twice: as a user calls it (its seconds and its launches,
    counted), then with its stages timed by wrappers around the module's
    functions (each call ended by a synchronize), which must give the same
    bits.  bigloop-97 is gated by SFM_GATES; sweep-50 over RANSAC streams
    against the JAX package's (SFM_REFERENCE): ``run_sfm_from_matches`` on
    the card on the sweep's own matches at the reference's seeds.  Then
    the JAX test's 6-frame sequence on the card against the CPU.  Returns
    the launch counts of the two sequences' counted runs together."""
    import numpy as np
    import torch

    from sift_tpu_torch import SiftConfig
    from sift_tpu_torch.models import sfm as SF
    from sift_tpu_torch.utils.profiling import StageTimer

    ev = port_script("torch_sfm_eval")
    render_sequence, trajectory_metrics, camera_centers = (
        ev.render_sequence, ev.trajectory_metrics, ev.camera_centers)
    cfg = SiftConfig(**SFM_CAPS)
    k = np.array(SFM_K)
    tex = ev.texture()
    stages = ("detect_and_describe", "match_descriptors", "_geometric_verify",
              "_candidate_counts", "_register_frame", "_triangulate_new", "_finish_global_ba",
              "pose_graph_relax", "_fill_unregistered_by_interpolation")
    timer, passes, init_pairs, inputs = StageTimer(), [], [], []
    spent, calls = timer.totals, timer.counts
    orig = {n: getattr(SF, n) for n in stages + ("run_sfm_from_matches",)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(name, fn):
        def run(*a, **kw):
            if name == "_finish_global_ba":
                init_pairs.append((int(a[6]), int(a[7])))
            sync()
            with timer.stage(name):
                out = fn(*a, **kw)
                sync()
            return out
        return run

    def by_pass(fn):
        def run(*a, **kw):
            inputs.append((a[0], dict(a[1])))
            before = dict(spent)
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            passes.append(dict(seconds=time.perf_counter() - t, **{
                n: spent.get(n, 0.0) - before.get(n, 0.0) for n in stages[2:7]}))
            return out
        return run

    def run(frames, device, ba_iters=SFM_BA_ITERS):
        for acc in (spent, passes, init_pairs, calls, inputs):
            acc.clear()
        t = time.perf_counter()
        res = SF.run_sfm(frames, k, cfg, ba_iters=ba_iters, match_window=SFM_WINDOW,
                         device=device)
        sync()
        return res, time.perf_counter() - t

    def same_result(a, b, what):
        need(np.array_equal(a.poses, b.poses) and np.array_equal(a.points, b.points)
             and a.info["registered"] == b.info["registered"], f"sfm {what} differ")

    def finite(res, what):
        need(np.isfinite(res.poses).all() and np.isfinite(res.points).all(),
             f"sfm {what}: non-finite poses or points")

    # As a user calls it: seconds, peak memory and launches.
    rendered = {name: render_sequence(tex, ts=ts) for name, ts in sfm_sequences().items()}
    launches, user = {}, {}
    for name, (frames, _) in rendered.items():
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        zero_counts()
        res, secs = run(frames, dev)
        launches[name] = read_counts()
        user[name] = (res, secs, torch.cuda.max_memory_allocated() - mem0)
    total = {kn: sum(v[kn] for v in launches.values()) for kn in launches[next(iter(launches))]}

    for n in stages:
        setattr(SF, n, timed(n, orig[n]))
    SF.run_sfm_from_matches = by_pass(orig["run_sfm_from_matches"])
    seqs = {}
    try:
        for name, (frames, gt) in rendered.items():
            res, total_s, peak = user[name]
            staged, staged_s = run(frames, dev)
            same_result(res, staged, f"{name}: the run with its stages timed and the user's run")
            if name.startswith("sweep-"):
                sweep_inputs = inputs[0]
            info, nf = res.info, len(frames)
            m = trajectory_metrics(camera_centers(res.poses), gt)
            finite(res, name)
            reg = info["registered"]
            m_reg = trajectory_metrics(camera_centers(res.poses)[reg], gt[reg])
            last = info.get("ba_reprune", info["ba"])["cost_trace"][-1]
            kept = info["n_obs"] - (info.get("pruned_obs", 0) if "ba_reprune" in info else 0)
            ba_rms = math.sqrt(last / kept)
            need(ba_rms <= SFM_MAX_BA_RMS_PX and info["ba"]["cost_trace"][-1] < info["ba"]["cost_trace"][0],
                 f"sfm {name}: bundle adjustment: RMS {ba_rms} px, costs {info['ba']['cost_trace']}")
            repaired = info.get("loop_pairs_added", 0) > 0 and "loop_closure_skipped" not in info
            gate = SFM_GATES.get(name)
            if gate:
                need(len(reg) >= gate["min_registered"], f"sfm {name}: {len(reg)} of {nf} frames registered")
                need(m["ate_pct_of_path"] <= gate["max_ate_pct"],
                     f"sfm {name}: ATE {m['ate_pct_of_path']:.3f}% of path")
                need(repaired, f"sfm {name}: the loop-closure repair did not run: "
                     f"{ {x: info.get(x) for x in ('loop_pairs_added', 'loop_closure_skipped')} }")
            want = dict(blur_pass=nf, octave_front_twin=nf * octaves_of(frames[0]),
                        top2=calls["match_descriptors"], detect=nf, orient=nf)
            got = {kn: launches[name][kn] for kn in want}
            need(got == want, f"sfm {name}: launches {launches[name]}, want {want}")
            seqs[name] = dict(
                frames=nf, registered=len(reg), unregistered=sorted(set(range(nf)) - set(reg)),
                points=info["n_points"], observations=info["n_obs"],
                pruned_obs=info.get("pruned_obs", 0), tracks=info["n_tracks"],
                loop_pairs_added=info.get("loop_pairs_added", 0),
                loop_closure_skipped=info.get("loop_closure_skipped"), repair_ran=repaired,
                init_pairs=init_pairs[:], **m,
                registered_ate_pct_of_path=m_reg["ate_pct_of_path"], ba_rms_px=ba_rms,
                ba_cost_first_last=[info["ba"]["cost_trace"][0], info["ba"]["cost_trace"][-1]],
                all_registered_and_ate_within_2pct=len(reg) == nf and m["ate_pct_of_path"] <= 2.0,
                seconds=total_s, seconds_with_stage_syncs=staged_s,
                stage_s={n: spent.get(n, 0.0) for n in stages}, passes=passes[:],
                calls=dict(calls), peak_mem_above_start_bytes=peak, launches=launches[name])

        # The card against the CPU on the JAX test's 6-frame sequence.
        frames, gt = render_sequence(tex)
        got = []
        for device in (dev, dev, torch.device("cpu")):
            res, secs = run(frames, device, 15)
            got.append((res, init_pairs[-1], secs))
    finally:
        for n, fn in orig.items():
            setattr(SF, n, fn)

    # sweep-50 over RANSAC streams: the sweep's own keypoints and matches,
    # the reference's seeds, on the card.
    sweep = f"sweep-{SFM_FRAMES}"
    sweep_frames, sweep_gt = rendered[sweep]
    rows = []
    t = time.perf_counter()
    for seed in SFM_STREAM_SEEDS:
        res = SF.run_sfm_from_matches(sweep_inputs[0], dict(sweep_inputs[1]), k, SFM_BA_ITERS,
                                      seed=seed, device=dev)
        finite(res, f"{sweep} seed {seed}")
        reg = res.info["registered"]
        centers = camera_centers(res.poses)
        rows.append(dict(seed=seed, registered=len(reg),
                         ate_pct=trajectory_metrics(centers, sweep_gt)["ate_pct_of_path"],
                         registered_ate_pct=trajectory_metrics(
                             centers[reg], sweep_gt[reg])["ate_pct_of_path"]))
    streams_s = time.perf_counter() - t
    ref = SFM_REFERENCE
    reg_stats = stream_stats([r["registered"] for r in rows])
    ate_stats = stream_stats([r["registered_ate_pct"] for r in rows])
    n, n_ref = len(rows), ref["registered"]["n"]
    min_mean = ref["registered"]["mean"] - 2.0 * math.sqrt(
        reg_stats["sd"] ** 2 / n + ref["registered"]["sd"] ** 2 / n_ref)
    need(reg_stats["mean"] >= min_mean,
         f"sfm {sweep} streams: {reg_stats['mean']} frames registered on average, "
         f"the reference's {ref['registered']['mean']} less two standard errors is {min_mean}")
    need(ate_stats["median"] <= ref["registered_ate_pct"]["q3"],
         f"sfm {sweep} streams: median ATE over the registered frames {ate_stats['median']}%, "
         f"above the reference's upper quartile {ref['registered_ate_pct']['q3']}%")
    seqs[sweep]["streams"] = dict(
        seeds=[r["seed"] for r in rows], registered=reg_stats, registered_ate_pct=ate_stats,
        all_registered_and_ate_within_2pct=sum(
            r["registered"] == len(sweep_frames) and r["ate_pct"] <= 2.0 for r in rows),
        min_mean_registered=min_mean, max_median_registered_ate_pct=ref["registered_ate_pct"]["q3"],
        reference=ref, seconds=streams_s, runs=rows)

    (rc, pc, sc), (rc2, _, _), (rp, pp, sp) = got
    # The card twice: RANSAC's samples come from a CPU generator and the
    # BA's sums have a fixed order, so a rerun gives the same bits.
    same_result(rc, rc2, "6-frame: two runs on the card")
    c_card, c_cpu = camera_centers(rc.poses), camera_centers(rp.poses)
    span = float(np.linalg.norm(c_cpu.max(0) - c_cpu.min(0)))
    vs = trajectory_metrics(c_card, c_cpu)
    need(rc.info["registered"] == rp.info["registered"],
         f"sfm 6-frame: registered {rc.info['registered']} on the card, {rp.info['registered']} on the CPU")
    need(pc == pp, f"sfm 6-frame: initial pair {pc} on the card, {pp} on the CPU")
    finite(rc, "6-frame")
    need(vs["max_dev_m"] <= SFM_CARD_CPU_TOL * span,
         f"sfm 6-frame: centres card vs CPU {vs['max_dev_m']} > {SFM_CARD_CPU_TOL} x span {span}")
    gt_card = trajectory_metrics(c_card, gt)
    emit(dict(phase="sfm", nvidia_smi=smi, frame_hw=[240, 320], fx=300.0,
              caps=SFM_CAPS, ba_iters=SFM_BA_ITERS, match_window=SFM_WINDOW, gates=SFM_GATES,
              max_ba_rms_px=SFM_MAX_BA_RMS_PX, sequences=seqs, launches=total,
              card_vs_cpu=dict(frames=len(frames), registered=rc.info["registered"],
                               init_pair=list(pc), points_card=rc.info["n_points"],
                               points_cpu=rp.info["n_points"], span_m=span,
                               max_dev_m=vs["max_dev_m"], max_dev_share_of_span=vs["max_dev_m"] / span,
                               rms_dev_m=vs["ate_rmse_m"], tol_share_of_span=SFM_CARD_CPU_TOL,
                               card_ate_pct_of_path=gt_card["ate_pct_of_path"],
                               card_rerun_bit_equal=True,
                               card_s=sc, cpu_s=sp)))
    return total


def rodrigues_np(w):
    """Rotation matrix of an axis-angle vector (numpy, float64)."""
    import numpy as np

    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = np.asarray(w) / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def chain_ba_scene(n_cams=PAR_BA_CAMS, n_pts=PAR_BA_POINTS, seed=0):
    """The parallel phase's BA problem: cameras 0.1 apart along x with a slow
    yaw, each point seen by a run of 3-8 consecutive cameras at depth 4-8;
    0.3 px noise, cameras 2.. perturbed by 0.03 and points by 0.05
    (tests/test_ba_dist.py:18-40's recipe), cameras 0 and 1 fixed.
    Returns (cams, points, obs_cam, obs_pt, obs_uv, fixed) as numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fxy, cxy = np.asarray(PAR_BA_FXY), np.asarray(PAR_BA_CXY)
    cams = np.zeros((n_cams, 6))
    rots = []
    for i in range(n_cams):
        cams[i, :3] = (0.0, 0.002 * i, 0.0)
        r = rodrigues_np(cams[i, :3])
        rots.append(r)
        cams[i, 3:] = -r @ np.array([0.1 * i, 0.0, 0.0])
    run = rng.integers(3, 9, n_pts)
    first = (rng.random(n_pts) * (n_cams - run + 1)).astype(np.int64)
    pts = np.stack([0.1 * (first + (run - 1) / 2) + rng.uniform(-0.3, 0.3, n_pts),
                    rng.uniform(-1, 1, n_pts), rng.uniform(4, 8, n_pts)], 1)
    obs_cam = np.concatenate([first + k for k in range(8)])
    obs_pt = np.tile(np.arange(n_pts), 8)
    keep = np.concatenate([k < run for k in range(8)])
    obs_cam, obs_pt = obs_cam[keep], obs_pt[keep]
    pc = np.einsum("oij,oj->oi", np.stack(rots)[obs_cam], pts[obs_pt]) + cams[obs_cam, 3:]
    obs_uv = pc[:, :2] / pc[:, 2:] * fxy + cxy + rng.normal(0, 0.3, (len(obs_cam), 2))
    cams_noisy = cams.copy()
    cams_noisy[2:] += rng.normal(0, 0.03, cams_noisy[2:].shape)
    pts_noisy = pts + rng.normal(0, 0.05, pts.shape)
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    return (cams_noisy, pts_noisy, obs_cam.astype(np.int32), obs_pt.astype(np.int32), obs_uv,
            fixed)


def parallel_phase(dev, smi, cfg, scfg, frames, octaves, ref_kp, want, t_script):
    """Phase ``parallel``: the multi-device layer (``sift_tpu_torch/parallel``)
    on PAR_RANKS ranks that share this card through gloo, one spawned pool
    for every leg, each rank's calls counted and timed by
    ``multihost.run_steps``:

    1. ``batched_detect`` of the BATCH frames over a (data 2, kp 2) mesh, each
       rank's share bit-equal to ``ref_kp`` (the main path's batch); then
       ``sharded_match`` of all pairs at kp = 2 on that mesh and at kp = 4 on
       a (1, 4) mesh, bit-equal to ``match_descriptors``, the 165-match set;
    2. ``spatial_detect_and_describe`` of CAVE 00 over a data axis of 4,
       against ``detect_stages`` under tests/test_spatial.py's tolerances;
    3. ``sharded_ba_solve`` of ``chain_ba_scene`` at kp = 4 against
       ``ba_solve`` under tests/test_ba_dist.py's gates;
    4. elastic recovery: the pair-0 B side saved, reloaded and matched on the
       mesh of ranks {0, 1}, and one BA step there, against kp = 4.

    Then NCCL at world size 1 in this process.  B, C, D, F (and H, which the
    staged functions build rows with) are held against their plain versions
    at the legs' shapes.  Returns rank 0's launches over the pool."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sift_tpu_torch import match_descriptors
    from sift_tpu_torch.config import gaussian_half_kernel
    from sift_tpu_torch.models import sift as S
    from sift_tpu_torch.models.ba import ba_problem_from_numpy, ba_solve, build_obs_by_point
    from sift_tpu_torch.models.pyramid import blur_half_kernels, compute_initial_image
    from sift_tpu_torch.ops.blur import separable_blur
    from sift_tpu_torch.ops.blur_pass import separable_blur_kernel
    from sift_tpu_torch.ops.color import to_grayscale
    from sift_tpu_torch.ops.octave_blur import octave_blur, octave_blur_plain
    from sift_tpu_torch.ops.octave_front import octave_front_twin, octave_front_twin_plain
    from sift_tpu_torch.ops.resize import downsample_nearest_x2, upsample_bilinear
    from sift_tpu_torch.ops.top2 import top2, top2_plain
    from sift_tpu_torch.ops.twin_rows import twin_rows_2d, twin_rows_2d_plain
    from sift_tpu_torch.parallel import multihost as MH
    from sift_tpu_torch.parallel.ba_dist import (
        shard_ba_problem,
        sharded_ba_solve,
        sharded_ba_step,
        sharded_cost,
    )
    from sift_tpu_torch.parallel.dist import batched_detect, sharded_match
    from sift_tpu_torch.parallel.mesh import make_mesh
    from sift_tpu_torch.parallel.spatial import (
        octave_dims,
        spatial_detect_and_describe,
        spatial_halo,
        window_of,
    )
    from sift_tpu_torch.utils.checkpoint import load_keypoints, save_keypoints
    from sift_tpu_torch.utils.keypoints import FIELDS

    t_phase = time.perf_counter()
    MeshSpec, Step, Earlier = MH.MeshSpec, MH.Step, MH.Earlier
    pairs = BATCH // 2
    d1, v1 = ref_kp.desc[0::2].cpu(), ref_kp.valid[0::2].cpu()
    d2, v2 = ref_kp.desc[1::2].cpu(), ref_kp.valid[1::2].cpu()
    cave00 = frames[0]
    ba = chain_ba_scene()
    n_obs = len(ba[2])
    fxy, cxy = np.asarray(PAR_BA_FXY), np.asarray(PAR_BA_CXY)
    sp4, _ = shard_ba_problem(*ba[:5], 4, fxy, cxy, ba[5], device="cpu")
    sp2, _ = shard_ba_problem(*ba[:5], 2, fxy, cxy, ba[5], device="cpu")
    survivors = MeshSpec(1, 2, ranks=(0, 1))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        state = f"{tmp}/pair0_b.npz"
        save_keypoints(state, ref_kp.map(lambda a: a[1].cpu()))
        legs = {"detect_match": [0, 1, 2], "spatial": [5], "ba": [6, 7], "elastic": [3, 4, 8, 9]}
        steps = [
            Step(batched_detect, (frames, cfg, octaves, MeshSpec(2, 2))),            # 0
            Step(sharded_match, (d1, v1, d2, v2, MeshSpec(2, 2), cfg.ratio_threshold)),  # 1
            Step(sharded_match, (d1, v1, d2, v2, MeshSpec(1, 4), cfg.ratio_threshold)),  # 2
            Step(load_keypoints, (state,), dict(device="cuda")),                      # 3
            Step(sharded_match, (d1[0], v1[0], Earlier(3, "desc"), Earlier(3, "valid"),
                                 survivors, cfg.ratio_threshold)),                   # 4
            Step(spatial_detect_and_describe, (cave00, scfg, MeshSpec(PAR_RANKS, 1))),  # 5
            Step(sharded_cost, (sp4, MeshSpec(1, 4))),                                # 6
            Step(sharded_ba_solve, (sp4, MeshSpec(1, 4)), dict(iters=PAR_BA_ITERS)),  # 7
            Step(sharded_ba_step, (sp4, 1e-3, MeshSpec(1, 4))),                       # 8
            Step(sharded_ba_step, (sp2, 1e-3, survivors)),                            # 9
        ]
        t0 = time.perf_counter()
        res = MH.run_steps(steps, PAR_RANKS, device="cuda", backend="gloo")
        pool_s = time.perf_counter() - t0

    def launched(st, **want_n):
        """Exactly the named launches (the rest 0) in step ``st`` on every rank
        that ran it."""
        for r, rr in enumerate(res):
            if rr[st] is None:
                continue
            got = {k: v for k, v in rr[st].launches.items() if v}
            need(got == want_n, f"parallel step {st} rank {r}: launches {got}, want {want_n}")

    # -- leg 1: data-parallel detection and kp-sharded matching -------------
    for r, rr in enumerate(res):
        for f in FIELDS:
            same(getattr(rr[0].out, f), getattr(ref_kp, f).cpu(), f"parallel rank {r} batched {f}")
    nkp = ref_kp.valid.sum(1).tolist()
    need(nkp[:2] == list(WANT_KP), f"parallel: keypoints {nkp[:2]}")
    ridx, racc, rbest, rsec = match_descriptors(d1, v1, d2, v2, cfg.ratio_threshold, device=dev)
    ridx, racc, rbest, rsec = (t.cpu() for t in (ridx, racc, rbest, rsec))
    for st, what in ((1, "kp 2 of (2, 2)"), (2, "kp 4 of (1, 4)")):
        for r, rr in enumerate(res):
            idx, acc, best, sec = rr[st].out
            need(torch.equal(acc, racc) and torch.equal(best, rbest) and torch.equal(sec, rsec)
                 and torch.equal(idx[acc], ridx[racc]),
                 f"parallel sharded_match {what} rank {r} differs from match_descriptors")
            for p in range(pairs):
                got = {(i, int(idx[p, i])) for i in np.nonzero(acc[p].numpy())[0]}
                need(got == want, f"parallel {what} rank {r} pair {p}: {len(got ^ want)} differ")
    launched(0, blur_pass=1, octave_front_twin=octaves, describe=1, detect=1, orient=1)
    launched(1, top2=1)
    launched(2, top2=1)

    # -- leg 2: row-sharded detection of one frame --------------------------
    ref_sp = S.detect_stages(cave00, scfg, octaves, device=dev)["final"]
    sp_out = res[0][5].out
    for r, rr in enumerate(res[1:], 1):
        for f in FIELDS:
            same(getattr(rr[5].out, f), getattr(sp_out, f), f"parallel spatial rank {r} {f}")

    def cols(k):
        v = k.valid.cpu().numpy()
        return (np.stack([getattr(k, f).cpu().numpy()[v].astype(np.float64)
                          for f in ("x", "y", "size", "pori")], 1),
                k.octave.cpu().numpy()[v], k.desc.cpu().numpy()[v])

    a, oct_a, desc_a = cols(sp_out)
    b, oct_b, desc_b = cols(ref_sp)
    need(len(a) == len(b), f"parallel spatial: {len(a)} keypoints, staged {len(b)}")
    tol = np.array([2e-3, 2e-3, 2e-3, 1e-3])
    close = (np.abs(a[None] - b[:, None]) <= tol).all(-1) & (oct_a[None] == oct_b[:, None])
    assign = close.argmax(1)
    need(bool(close.any(1).all()) and len(set(assign.tolist())) == len(b),
         "parallel spatial: no 1:1 assignment within the tolerances")
    dd = np.abs(desc_a[assign].astype(np.int32) - desc_b.astype(np.int32))
    off2, off0 = float((dd > 2).mean()), float((dd != 0).mean())
    need(off2 < 0.001 and off0 < 0.05, f"parallel spatial: descriptor bytes off {off2}, {off0}")
    max_dev = np.abs(a[assign] - b).max(0).tolist()
    launched(5, octave_blur=octaves, blur_pass=1, twin_rows_2d=3 * octaves, describe=octaves,
             orient=octaves)

    # -- leg 3: point-sharded bundle adjustment ------------------------------
    def problem_f32():
        cams, pts, oc, op, uv, fixed = ba
        return ba_problem_from_numpy(dict(
            cams=cams.astype(np.float32), points=pts.astype(np.float32), obs_cam=oc, obs_pt=op,
            obs_uv=uv.astype(np.float32), obs_mask=np.ones(n_obs, bool),
            obs_by_point=build_obs_by_point(op, len(pts)), fxy=fxy.astype(np.float32),
            cxy=cxy.astype(np.float32), fixed_cams=fixed), dev)

    t0 = time.perf_counter()
    cams_ref, _, info_ref = ba_solve(problem_f32(), iters=PAR_BA_ITERS)
    torch.cuda.synchronize()
    ba_single_s = time.perf_counter() - t0
    ref_trace = info_ref["cost_trace"]
    cost0 = float(res[0][6].out)
    sp_solved, info = res[0][7].out
    trace = info["cost_trace"]
    need(abs(cost0 - ref_trace[0]) < 1e-2 * cost0, f"parallel BA: cost0 {cost0} vs {ref_trace[0]}")
    need(trace[-1] < 0.05 * ref_trace[0], f"parallel BA: final {trace[-1]} of {ref_trace[0]}")
    ba_rel = abs(trace[-1] - ref_trace[-1]) / max(ref_trace[-1], 1e-6)
    need(ba_rel < 0.05, f"parallel BA: final {trace[-1]} vs single-process {ref_trace[-1]}")
    ba_cam_err = float((sp_solved["cams"] - cams_ref.cpu()).abs().max())
    need(ba_cam_err <= 5e-3, f"parallel BA: cameras off by {ba_cam_err}")
    for r, rr in enumerate(res[1:], 1):
        same(rr[7].out[0]["cams"], sp_solved["cams"], f"parallel BA rank {r} cameras")

    # -- elastic recovery -----------------------------------------------------
    for r, rr in enumerate(res):
        need((rr[4] is None) == (r not in survivors.ranks), f"parallel: rank {r} survivors step")
    for r in survivors.ranks:
        for name, x, y in zip(("idx", "accept", "best", "second"), res[r][4].out,
                              (t[0] for t in res[0][2].out)):
            same(x, y, f"parallel elastic rank {r} {name} vs kp 4")
    launched(4, top2=1)
    cams4, _, c4 = res[0][8].out
    cams2, _, c2 = res[0][9].out
    el_cost_rel = abs(float(c4) - float(c2)) / max(float(c4), 1.0)
    el_cam_err = float((cams4 - cams2).abs().max())
    need(el_cost_rel < 1e-3 and el_cam_err <= 5e-3,
         f"parallel elastic BA: cost {float(c4)} vs {float(c2)}, cameras {el_cam_err}")

    # -- the kernels against their plain versions at the legs' shapes ---------
    hks = blur_half_kernels(cfg)
    share = S.as_batch(frames[: BATCH // 2], cfg, dev)
    gray = upsample_bilinear(to_grayscale(share).to(cfg.dtype), 2, 2).contiguous()
    pre = gaussian_half_kernel(math.sqrt(cfg.init_sigma * cfg.init_sigma - 1))
    errs = dict(D=same(separable_blur_kernel(gray, pre), separable_blur(gray, pre),
                       "parallel kernel D batch 8"))
    seed = compute_initial_image(share, cfg).contiguous()
    plan = S.front_twin_plan(cfg, octaves, *seed.shape[1:])
    need(all(o[3] for o in plan.octaves), f"parallel: front-twin plan {plan.octaves}")
    bufs = [(torch.zeros((len(share), plan.g_total, 2 * plan.blk), device=dev),
             torch.zeros((len(share), plan.pk_total, 128), device=dev)) for _ in range(2)]
    thr = cfg.extremum_threshold()
    sd = [seed, seed]
    errs["F"] = 0.0
    for (h, w, st_, fits, nbt, gbase), pkbase in zip(plan.octaves, plan.pk_bases):
        outs = [fn(sd[i], hks, thr, bufs[i][0], gbase, st_, plan.blk, plan.g_l0, plan.g_nl,
                   bufs[i][1], pkbase) for i, fn in enumerate((octave_front_twin,
                                                                octave_front_twin_plain))]
        for name, x, y in zip(("mask", "counts", "down"), *outs):
            errs["F"] = max(errs["F"], same(x, y, f"parallel kernel F batch 8 {name}"))
        sd = [downsample_nearest_x2(o[2]).contiguous() for o in outs]
    for i in range(2):
        errs["F"] = max(errs["F"], same(bufs[0][i], bufs[1][i], "parallel kernel F buffers"))
    del bufs
    errs["B"] = 0.0
    b_shapes = []
    for nkp_ in (2, 4):
        w = d2.shape[1] // nkp_
        for p_ in (pairs, 1):
            for k in range(nkp_):
                x1 = d1[:p_].to(dev).contiguous()
                x2 = d2[:p_, k * w:(k + 1) * w].to(dev).contiguous()
                xv = v2[:p_, k * w:(k + 1) * w].to(dev).contiguous()
                for name, x, y in zip(("best", "second", "idx"), top2(x1, x2, xv),
                                      top2_plain(x1, x2, xv)):
                    errs["B"] = max(errs["B"], same(x, y, f"parallel kernel B {name} "
                                                          f"({p_}, {x1.shape[1]}, {w})"))
            b_shapes.append([p_, int(d1.shape[1]), w])
    s0 = compute_initial_image(S.as_batch(cave00[None], scfg, dev), scfg)[0]
    halo = spatial_halo(scfg)
    h0, _ = octave_dims(*s0.shape, 1)[0]
    errs["C"] = errs["H"] = 0.0
    win_shapes = []
    for shard in (0, 1):
        _, _, wstart, win = window_of(h0, shard, PAR_RANKS, halo)
        window = s0[None, wstart: wstart + win].contiguous()
        g_c, d_c = octave_blur(window, hks)
        g_p, d_p = octave_blur_plain(window, hks)
        errs["C"] = max(errs["C"], same(g_c, g_p, f"parallel kernel C gauss rank {shard} window"),
                        same(d_c, d_p, f"parallel kernel C dog rank {shard} window"))
        for vol in (g_c[0], d_c[0]):
            m2 = vol.reshape(-1, vol.shape[-1]).contiguous()
            errs["H"] = max(errs["H"], same(twin_rows_2d(m2, 128), twin_rows_2d_plain(m2, 128),
                                            f"parallel kernel H rank {shard} window"))
        win_shapes.append([1, win, int(s0.shape[1])])

    # -- NCCL at world size 1, in this process --------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        MH.initialize(f"file://{tmp}/rendezvous", num_processes=1, process_id=0, backend="nccl")
        try:
            need(dist.get_backend() == "nccl" and MH.fleet_barrier() == 1, "NCCL world 1")
            mesh = make_mesh(1, 1)
            got = sharded_match(d1[0], v1[0], d2[0], v2[0], mesh, cfg.ratio_threshold)
            for name, x, y in zip(("idx", "accept", "best", "second"), got,
                                  (t[0] for t in (ridx, racc, rbest, rsec))):
                same(x.cpu(), y, f"NCCL world 1 sharded_match {name}")
            sp1, _ = shard_ba_problem(*ba[:5], 1, fxy, cxy, ba[5], device=dev)
            n_cost0 = float(sharded_cost(sp1, mesh))
            cams1, pts1, _ = sharded_ba_step(sp1, 1e-3, mesh)
            n_cost1 = float(sharded_cost(dict(sp1, cams=cams1, points=pts1), mesh))
            need(n_cost1 < n_cost0, f"NCCL world 1: BA step {n_cost0} -> {n_cost1}")
        finally:
            dist.destroy_process_group()

    def sweep():
        out = S.detect_and_describe_batch(S.as_batch(frames, cfg, dev), cfg, device=dev)
        return match_descriptors(out.desc[0::2], out.valid[0::2], out.desc[1::2],
                                 out.valid[1::2], cfg.ratio_threshold, device=dev)

    sweep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_SWEEPS):
        sweep()
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3 / TIMED_SWEEPS

    def leg_s(rr, name):
        return sum(rr[i].seconds for i in legs[name] if rr[i] is not None)

    total = {}
    for st in res[0]:
        for k, v in st.launches.items():
            total[k] = total.get(k, 0) + v
    emit(dict(
        phase="parallel", nvidia_smi=smi, ranks=PAR_RANKS, backend="gloo on one card",
        pool_s=pool_s, leg_s_per_rank={k: [leg_s(rr, k) for rr in res] for k in legs},
        step_s_per_rank=[[None if x is None else x.seconds for x in rr] for rr in res],
        launches_per_rank=[[None if x is None else {k: v for k, v in x.launches.items() if v}
                            for x in rr] for rr in res],
        peak_mem_gib_per_rank=[max(x.peak_bytes for x in rr if x is not None) / 2**30
                               for rr in res],
        detect_match=dict(batch=BATCH, mesh=[2, 2], keypoints=nkp[:2], matches=WANT_MATCHES,
                          bit_equal=True, kp_widths=[2, 4]),
        spatial=dict(frame_hw=list(cave00.shape[:2]), octaves=octaves, halo=halo,
                     keypoints=len(a), staged_keypoints=len(b), max_abs_dev_xy_size_pori=max_dev,
                     desc_bytes_off_gt2=off2, desc_bytes_off=off0, window_shapes=win_shapes),
        ba=dict(cams=PAR_BA_CAMS, points=PAR_BA_POINTS, observations=n_obs, kp=4,
                iters=PAR_BA_ITERS, cost_trace=trace, single_process_cost_trace=ref_trace,
                final_rel_vs_single=ba_rel, cams_max_abs_diff=ba_cam_err,
                single_process_s=ba_single_s),
        elastic=dict(survivors=list(survivors.ranks), match_bit_equal=True,
                     ba_step_cost_rel=el_cost_rel, ba_step_cams_max_abs_diff=el_cam_err),
        nccl_world1=dict(match_bit_equal=True, ba_cost=[n_cost0, n_cost1]),
        kernels_vs_plain=dict(max_abs_err=errs, b_shapes=b_shapes, c_h_window_shapes=win_shapes,
                              d_f_batch=BATCH // 2),
        single_process_sweep_ms=single_ms, phase_s=time.perf_counter() - t_phase,
        script_s=time.perf_counter() - t_script))
    return total


# bench.py's streaming capacities (bench.py:148-150), for the report of
# what they clip on the scene.
JAX_STREAM_CAPS = dict(extrema_cap=8192, kp_cap=2048, ori_cap=3072)
STREAM_BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "best", "batch", "method",
                       "stream_fps", "stream_method", "stream_in_memory_fps",
                       "stream_h2d_ceiling_fps", "stream_h2d_MBps", "stream_caps", "device")


def h2d_trace_bytes(fn, trace_path) -> int:
    """Bytes that ``fn`` copies host to device, read from a
    ``torch.profiler`` trace of one call (the memcpy events' ``bytes``)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    return sum(int(e.get("args", {}).get("bytes", 0)) for e in events
               if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))


def stream_phase(dev, smi, cfg, frames, main_kp, oracle_set, octaves, zero_counts,
                 read_counts):
    """Phase ``stream``: the streaming path (``sift_tpu_torch.bench``,
    ``utils/native.ImageLoader``, ``scripts/torch_scene_throughput.py``).
    Gates: (1) the 35 scene frames as PNG through ``ImageLoader`` at 1 and
    8 threads, in order and bit-equal to the npz inputs, and a missing path
    raising ``IOError`` at its own position; (2) ``as_batch`` moves a host
    uint8 batch as uint8 (bytes copied host to device, from a profiler
    trace, before and after the repair); (3) the pair x8 as a pinned uint8
    card tensor (``bench.stage_batches``) gives the float32 main path's
    buffers bit for bit and the 165-match set on every pair; (4) the
    honesty scan passes at ``bench.STREAM_CAPS`` on all 35 frames, and what
    bench.py's caps clip is printed; (5) the scene streamed from disk
    (``bench.scene_matches``: batch 8, 4 threads, default capacities)
    equals the entry point on the frames held in memory, frame by frame,
    and its 34 consecutive-pair match sets equal the matcher's; (6)
    launches: one streamed sweep D 1, F one an octave, B 1, the scene loop
    D 5, F 5 x octaves, B 9, nothing else; (7) ``pairwise_sq_dists`` at
    2048 x 2048 equals the exact integers, its row minima and first argmins
    kernel B's; (8) ``python -m sift_tpu_torch.bench`` (short: 2 sweeps, 1
    repeat, 1 streamed sweep) and ``scripts/torch_scene_throughput.py`` on
    the PNGs as subprocesses, their lines complete (35 frames, 34 pairs,
    the library's median).  Returns the launches of (6)."""
    import numpy as np
    import torch

    from sift_tpu_torch import SiftConfig, match_descriptors, pairwise_sq_dists
    from sift_tpu_torch import bench as BN
    from sift_tpu_torch.models import sift as S
    from sift_tpu_torch.ops.top2 import top2
    from sift_tpu_torch.utils import native
    from sift_tpu_torch.utils.keypoints import FIELDS
    from sift_tpu_torch.utils.native import ImageLoader

    t_phase = time.perf_counter()
    need(native.available(), f"the native library does not build here (recipes {native.recipes()})")
    scene = BN.scene_frames()
    launches = {}

    def match_set(idx, acc):
        acc, idx = acc.cpu().numpy(), idx.cpu().numpy()
        return {(i, int(idx[i])) for i in np.nonzero(acc)[0]}

    def expect(path, want):
        rest = {k: 0 for k in launches[path] if k not in want}
        need(launches[path] == {**rest, **want}, f"{path}: launches {launches[path]}, want {want}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pdir = tmp / "scene"
        pdir.mkdir()
        paths = BN.write_pngs(scene, pdir)

        # (1) the loader
        for threads in (1, 8):
            with ImageLoader(paths, threads) as loader:
                got = list(loader)
            need(len(got) == len(scene), f"loader, {threads} threads: {len(got)} frames")
            for i, (g, s) in enumerate(zip(got, scene)):
                need(g.dtype == np.float32 and g.shape == s.shape and np.array_equal(g, s),
                     f"loader, {threads} threads: frame {i} differs from the npz input")
        del got
        holed = paths[:3] + [str(tmp / "missing.png")] + paths[3:6]
        with ImageLoader(holed, 8) as loader:
            head = [next(loader) for _ in range(3)]
            try:
                next(loader)
                raised = None
            except OSError as e:
                raised = str(e)
            tail = list(loader)
        need(raised is not None and "frame 3" in raised, f"a missing path raised {raised!r}")
        need(len(tail) == 3 and all(np.array_equal(a, b) for a, b in zip(head + tail, scene[:6])),
             "the frames around a missing path")
        t = time.perf_counter()
        with ImageLoader(paths, 8) as loader:
            n_dec = sum(1 for _ in loader)
        decode_fps = n_dec / (time.perf_counter() - t)

        # (2) as_batch on a host uint8 batch: bytes across, before and after
        old = lambda: torch.as_tensor(frames).to(device=dev, dtype=cfg.dtype)  # noqa: E731
        new = lambda: S.as_batch(frames, cfg, dev)  # noqa: E731
        same(old(), new(), "as_batch: the repaired conversion vs the one-step copy")
        h2d_old = h2d_trace_bytes(old, tmp / "old.json")
        h2d_new = h2d_trace_bytes(new, tmp / "new.json")
        need(h2d_new == frames.nbytes, f"as_batch copied {h2d_new} bytes host to device, "
             f"the uint8 batch holds {frames.nbytes}")
        as_batch_ms = [host_ms(fn, 5) for fn in (old, new, new, old)]

        # (3) the uint8 path: the pair x8 as a pinned uint8 card tensor
        staged = list(BN.stage_batches(frames, len(frames), dev))
        need(len(staged) == 1 and staged[0][1] == len(frames), "the pair batch staged in one")
        u8 = staged[0][0]
        need(u8.dtype == torch.uint8 and u8.device.type == "cuda", f"staged {u8.dtype} {u8.device}")
        ku = S.detect_and_describe_batch(u8, cfg, device=dev)
        for f in FIELDS:
            same(getattr(ku, f), getattr(main_kp, f), f"uint8 batch vs the float32 main path: {f}")
        mi, ma, _, _ = match_descriptors(ku.desc[0::2], ku.valid[0::2], ku.desc[1::2],
                                         ku.valid[1::2], cfg.ratio_threshold, device=dev)
        for p in range(ma.shape[0]):
            need(match_set(mi[p], ma[p]) == oracle_set, f"uint8 batch pair {p}: match set")
        u8_kp = ku.valid.sum(1).tolist()[:2]
        del staged, u8, ku

        # (4) the honesty scan at the bench's capacities; what bench.py's clip
        scfg = SiftConfig(**BN.STREAM_CAPS)
        try:
            most = BN.honesty_scan(paths, scfg, BATCH, 8, dev)
        except BN.CapacityError as e:
            raise SmokeError(f"stream honesty scan at {BN.STREAM_CAPS}: {e}") from e
        jcfg = SiftConfig(**JAX_STREAM_CAPS)
        jax_clips = []
        with ImageLoader(paths, 8) as loader:
            for k, (b, n) in enumerate(BN.stage_batches(loader, BATCH, dev)):
                _, c = S.detect_and_describe_batch(b, jcfg, return_counts=True, device=dev)
                jax_clips += S.clipped(c, jcfg, n, k * BATCH)

        # (5) + (6) the scene from disk against the frames in memory, counted
        dcfg = SiftConfig()
        zero_counts()
        skp, (sidx, sacc) = BN.scene_matches(paths, dcfg, 8, 4, dev)
        launches["stream_scene"] = read_counts()
        n_pairs = SCENE_FRAMES - 1
        n_batches = -(-SCENE_FRAMES // 8)
        expect("stream_scene", dict(blur_pass=n_batches, octave_front_twin=n_batches * octaves,
                                    top2=-(-n_pairs // 4), describe=n_batches, detect=n_batches,
                                    orient=n_batches))
        refs = []
        for lo in range(0, SCENE_FRAMES, 8):
            chunk = scene[lo:lo + 8]
            chunk = chunk + [chunk[-1]] * (8 - len(chunk))
            refs.append(S.detect_and_describe_batch(np.stack(chunk), dcfg, device=dev).map(
                lambda a, n=min(8, SCENE_FRAMES - lo): a[:n]))
        ref = type(skp)(**{f: torch.cat([getattr(r, f) for r in refs]) for f in FIELDS})
        for f in FIELDS:
            same(getattr(skp, f), getattr(ref, f), f"streamed scene vs in memory: {f}")
        pair_matches = []
        for i in range(n_pairs):
            ri, ra, _, _ = match_descriptors(ref.desc[i], ref.valid[i], ref.desc[i + 1],
                                             ref.valid[i + 1], dcfg.ratio_threshold, device=dev)
            want = match_set(ri, ra)
            need(match_set(sidx[i], sacc[i]) == want, f"streamed scene pair {i}-{i + 1}")
            pair_matches.append(len(want))
        median_matches = int(np.median(pair_matches))
        del skp, refs, ref

        zero_counts()
        BN.stream_sweeps(paths, scfg, BATCH, 1, 8, dev)
        launches["stream"] = read_counts()
        expect("stream", dict(blur_pass=1, octave_front_twin=octaves, top2=1, describe=1,
                              detect=1, orient=1))

        # (7) pairwise_sq_dists on the card against the exact integers and kernel B
        rng = np.random.default_rng(7)
        da = rng.integers(0, 256, (2048, 128), dtype=np.uint8)
        db = rng.integers(0, 256, (2048, 128), dtype=np.uint8)
        db[[5, 9]] = da[0]  # a tie: the first column wins
        da[1] = 255
        d2 = pairwise_sq_dists(da, db, device=dev)
        torch.cuda.synchronize()
        fa, fb = da.astype(np.float64), db.astype(np.float64)  # exact: integers < 2^53
        exact = ((fa * fa).sum(1)[:, None] + (fb * fb).sum(1)[None, :]
                 - 2 * fa @ fb.T).astype(np.int64)
        d2h = d2.cpu().numpy()
        need(d2.dtype == torch.int32 and np.array_equal(d2h.astype(np.int64), exact),
             "pairwise_sq_dists on the card differs from the exact integers")
        ta, tb = (torch.from_numpy(x).to(dev)[None] for x in (da, db))
        best, _, bidx = top2(ta, tb, torch.ones(1, len(db), dtype=torch.bool, device=dev))
        need(np.array_equal(d2h.min(1), best[0].cpu().numpy())
             and np.array_equal(d2h.argmin(1), bidx[0].cpu().numpy()),
             "pairwise_sq_dists' row minima / first argmins differ from kernel B's")
        pairwise_ms = cuda_ms(lambda: pairwise_sq_dists(ta[0], tb[0], device=dev), 10)
        del d2, ta, tb

        # (8) the bench and the scene script as a user runs them
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "sift_tpu_torch.bench", "--sweeps", "2",
                               "--repeats", "1", "--stream-sweeps", "1", "--stream-repeats", "1"],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        bench_wall_s = time.perf_counter() - t
        need(proc.returncode == 0, f"python -m sift_tpu_torch.bench exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        need(set(STREAM_BENCH_FIELDS) <= set(line),
             f"the bench's line lacks {set(STREAM_BENCH_FIELDS) - set(line)}")
        need(line["stream_caps"] == BN.STREAM_CAPS and line["unit"] == "frames/s"
             and line["device"] == smi, f"the bench's line: {line}")
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_scene_throughput.py"),
                               str(pdir)], cwd=ROOT, capture_output=True, text=True, timeout=600)
        scene_wall_s = time.perf_counter() - t
        need(proc.returncode == 0, f"torch_scene_throughput.py exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
        sline = json.loads(proc.stdout.strip().splitlines()[-1])
        need((sline["frames"], sline["pairs_matched"], sline["median_pair_matches"])
             == (SCENE_FRAMES, n_pairs, median_matches), f"the scene script's line: {sline}")

    emit(dict(phase="stream", nvidia_smi=smi, frames=SCENE_FRAMES,
              loader=dict(threads=[1, 8], bit_equal=True, missing_path=raised,
                          decode_fps_8_threads=decode_fps),
              as_batch_h2d_bytes=dict(one_step=h2d_old, repaired=h2d_new,
                                      uint8_batch=frames.nbytes),
              as_batch_ms_turns=dict(one_step=[as_batch_ms[0], as_batch_ms[3]],
                                     repaired=as_batch_ms[1:3]),
              uint8_path=dict(keypoints=u8_kp, matches=len(oracle_set), bit_equal=True),
              stream_caps=BN.STREAM_CAPS, stream_max_counts=most,
              jax_stream_caps=JAX_STREAM_CAPS, jax_stream_caps_clip=jax_clips,
              scene_loop=dict(batch=8, threads=4, pairs=n_pairs, median_matches=median_matches,
                              equal_to_in_memory=True),
              launches=launches, pairwise_2048_ms=pairwise_ms,
              bench=dict(wall_s=bench_wall_s, line=line),
              scene_script=dict(wall_s=scene_wall_s, line=sline),
              resident_fps=line["value"], stream_fps=line["stream_fps"],
              h2d_ceiling_fps=line["stream_h2d_ceiling_fps"],
              phase_s=time.perf_counter() - t_phase))
    return launches


# Kernel I's cells: the benchmark's resident_b16 (16 frames of CAVE-01 at
# its capacities) and cli_pair (the demo pair at SiftConfig()).
DESCRIBE_CELLS = dict(
    resident_b16=([f"scene_oracle/cave01_{i:02d}.npz" for i in range(16)],
                  dict(extrema_cap=12288, kp_cap=2048, ori_cap=3072)),
    cli_pair=(["oracle_demo1.npz", "oracle_demo2.npz"], {}),
)
# Kernel I's float32 operations a window sample (csrc/describe.cu), a
# transcendental call counted as one: rotation and bins 10, gradient,
# magnitude, angle and weight 14, the three bins' weights 11, eight
# histogram terms of three operations 24.
DESCRIBE_OPS = 59


def describe_phase(dev, smi):
    """Kernel I at the benchmark cells' shapes, on the main path's gauss
    space: bit for bit against ``describe_ordered_plain``, again against
    itself, against the plain chain up to the order of sums (its measured
    max |diff| is the table's ``max_abs_err``); timed (CUDA
    events around the wrapper, and the device time from a graph replay)
    beside the plain chain and the bound (each valid lane's patch read
    once, 128 bytes a lane written, the keypoint fields read once; or its
    window's operations).  Returns the kernel table's numbers by cell."""
    import numpy as np
    import torch

    from sift_tpu_torch import SiftConfig, kernels
    from sift_tpu_torch.models import descriptor as De
    from sift_tpu_torch.models import sift as S
    from sift_tpu_torch.ops import describe as D

    out = {}
    for name, (files, caps) in DESCRIBE_CELLS.items():
        cfg = SiftConfig(**caps)
        imgs = S.as_batch(np.stack([np.load(DATA / f)["input"] for f in files]), cfg, dev)
        gsp, dsp, masks, counts = S.front_twin(imgs, cfg)
        kp, _ = S.detect_refine(dsp, masks, counts, cfg)
        del dsp, masks, counts
        allkp = S.dedup(S.orient(gsp, kp, cfg)[0], cfg)
        before = kernels.launch_counts()["describe"]
        got = De.compute_descriptors_all(gsp, allkp, cfg)
        need(kernels.launch_counts()["describe"] == before + 1, f"kernel I {name}: not one launch")
        order_err = same(got, D.describe_ordered_plain(gsp, allkp, cfg,
                                                        De.desc_radius_classes(cfg)),
                         f"kernel I {name} vs describe_ordered_plain")
        same(got, De.compute_descriptors_all(gsp, allkp, cfg), f"kernel I {name}, two launches")
        plain = De.compute_descriptors_plain(gsp, allkp, cfg)
        v = allkp.valid
        diff = (got.int() - plain.int())[v].abs()
        need(int(diff.max()) <= 1 and int((diff != 0).sum()) <= diff.numel() // 1000,
             f"kernel I {name} vs the plain chain: {int((diff != 0).sum())} bytes off")
        need(int(got[~v].int().abs().sum()) == 0, f"kernel I {name}: invalid lanes not zero")
        radius = De._lane_args(gsp, allkp, cfg, None)[1][De._RADIUS]
        r = radius.clamp(0, De.desc_radius_bound(cfg)).double()
        lanes = v.numel()
        patch_bytes = float(((2 * r + 3) ** 2).sum()) * 4
        t_bytes = (patch_bytes + lanes * (128 + 6 * 4 + 1)) / HBM_BPS * 1e3
        t_ops = float(((2 * r + 1) ** 2).sum()) * DESCRIBE_OPS / F32_OPS * 1e3
        b_ms, b_by = bound(t_bytes, t_ops)
        call = lambda: De.compute_descriptors_all(gsp, allkp, cfg)  # noqa: E731
        out[name] = dict(
            frames=len(files), lanes=lanes, valid=int(v.sum()),
            ms=cuda_ms(call, KERNEL_REPS), device_ms=graph_ms(call, KERNEL_REPS),
            plain_ms=host_ms(lambda: De.compute_descriptors_plain(gsp, allkp, cfg), 3),
            bound_ms=b_ms, bound_by=b_by, bytes_ms=t_bytes, ops_ms=t_ops,
            plain_bytes_off=int((diff != 0).sum()), bytes=int(diff.numel()),
            max_abs_err=int(diff.max()), order_model_max_abs_err=order_err)
        del gsp, kp, allkp, got, plain
    emit(dict(phase="describe_kernel", nvidia_smi=smi, bit_equal_to_order_model=True,
              cells=out))
    return out


# Kernel K's float32 operations a window sample (csrc/describe.cu), a
# transcendental call counted as one: the two gradients 2, the magnitude 4,
# the angle 1, the bin 5 (shift, scale, divide, round), the weight 2 and the
# histogram's sum 1.
ORIENT_OPS = 15


def orient_phase(dev, smi):
    """Kernel K at the benchmark cells' shapes, on the main path's gauss
    space and refined keypoints: bit for bit against
    ``orient_ordered_plain``, again against itself, against the plain chain
    up to the order of sums (the same candidates, pori within 1e-5 rad: the
    measured max |diff| is the table's ``max_abs_err``); timed (CUDA events
    around the wrapper, and the device time from a graph replay) beside the
    plain chain and the bound (each valid lane's (2r + 3)^2 patch read once,
    the keypoint fields read once, the candidates written once; or its
    window's operations).  Returns the kernel table's numbers by cell."""
    import numpy as np

    from sift_tpu_torch import SiftConfig, kernels
    from sift_tpu_torch.models import orient as O
    from sift_tpu_torch.models import sift as S
    from sift_tpu_torch.ops import orient as OK
    from sift_tpu_torch.utils.keypoints import FIELDS

    out = {}
    for name, (files, caps) in DESCRIBE_CELLS.items():
        cfg = SiftConfig(**caps)
        imgs = S.as_batch(np.stack([np.load(DATA / f)["input"] for f in files]), cfg, dev)
        gsp, dsp, masks, counts = S.front_twin(imgs, cfg)
        kp, _ = S.detect_refine(dsp, masks, counts, cfg)
        del dsp, masks, counts
        before = kernels.launch_counts()["orient"]
        cand, peaks = O.orient_all(gsp, kp, cfg)
        need(kernels.launch_counts()["orient"] == before + 1, f"kernel K {name}: not one launch")
        want, pw = OK.orient_ordered_plain(gsp, kp, cfg, O.ori_radius_classes(cfg))
        again, pa = O.orient_all(gsp, kp, cfg)
        for f in FIELDS:
            same(getattr(cand, f), getattr(want, f), f"kernel K {name} {f} vs the order model")
            same(getattr(again, f), getattr(cand, f), f"kernel K {name} {f}, two launches")
        need(int(peaks) == int(pw) == int(pa), f"kernel K {name}: max_peaks {int(peaks)}, "
             f"model {int(pw)}")
        plain, pp = O.orient_plain(gsp, kp, cfg)
        for f in ("valid", "x", "y", "size", "octave", "layer"):
            same(getattr(cand, f), getattr(plain, f), f"kernel K {name} {f} vs the plain chain")
        v = cand.valid
        err = float((cand.pori - plain.pori)[v].abs().max())
        need(err <= 1e-5 and int(peaks) == int(pp),
             f"kernel K {name} vs the plain chain: pori off by {err}")
        radius = O._lane_args(gsp, kp, cfg, None)[1][O._RADIUS]
        r = radius.clamp(0, O.ori_radius_bound(cfg)).double()
        lanes = kp.valid.numel()
        t_bytes = (float(((2 * r + 3) ** 2).sum()) * 4 + lanes * (5 * 4 + 1)
                   + v.numel() * (6 * 4 + 1)) / HBM_BPS * 1e3
        t_ops = float(((2 * r + 1) ** 2).sum()) * ORIENT_OPS / F32_OPS * 1e3
        b_ms, b_by = bound(t_bytes, t_ops)
        call = lambda: O.orient_all(gsp, kp, cfg)  # noqa: E731
        out[name] = dict(
            frames=len(files), lanes=lanes, valid=int(kp.valid.sum()), candidates=int(v.sum()),
            max_peaks=int(peaks), ms=cuda_ms(call, KERNEL_REPS),
            device_ms=graph_ms(call, KERNEL_REPS),
            plain_ms=host_ms(lambda: O.orient_plain(gsp, kp, cfg), 3),
            bound_ms=b_ms, bound_by=b_by, bytes_ms=t_bytes, ops_ms=t_ops, max_abs_err=err)
        del gsp, kp, cand, want, again, plain
    emit(dict(phase="orient_kernel", nvidia_smi=smi, bit_equal_to_order_model=True, cells=out))
    return out


# Kernel J's bound: per valid extremum lane five reads of a 27-value float32
# cube (the cascade's most steps) and its fields, 4 int32 in, 4 floats out.
DETECT_LANE_BYTES = 5 * 27 * 4 + 32


def detect_phase(dev, smi):
    """Kernel J at the benchmark cells' shapes, on the main path's DoG
    space: bit for bit against the plain chain (``extrema_from_counts`` +
    ``_refine``) in every field, the counts and the lane order, again
    against itself; timed (CUDA events around the wrapper, and the device
    time from a graph replay) beside the plain chain and the bound (the
    popcounts and the masks' rows that hold extrema read once, each valid
    lane's ``DETECT_LANE_BYTES``, the (B, kp_cap) output written once).
    Returns the kernel table's numbers by cell."""
    import numpy as np

    from sift_tpu_torch import SiftConfig, kernels
    from sift_tpu_torch.models import sift as S
    from sift_tpu_torch.models.detect import extrema_from_counts
    from sift_tpu_torch.ops import detect as DJ
    from sift_tpu_torch.utils.keypoints import FIELDS

    out = {}
    for name, (files, caps) in DESCRIBE_CELLS.items():
        cfg = SiftConfig(**caps)
        imgs = S.as_batch(np.stack([np.load(DATA / f)["input"] for f in files]), cfg, dev)
        _, dsp, masks, counts = S.front_twin(imgs, cfg)

        def plain():
            return S._refine(dsp, *extrema_from_counts(masks, counts, cfg.extrema_cap), cfg)

        before = kernels.launch_counts()["detect"]
        kp, c = S.detect_refine(dsp, masks, counts, cfg)
        need(kernels.launch_counts()["detect"] == before + 1, f"kernel J {name}: not one launch")
        want, wc = plain()
        err = 0.0
        for f in FIELDS:
            err = max(err, same(getattr(kp, f), getattr(want, f), f"kernel J {name} {f}"))
        for k in wc:
            same(c[k], wc[k], f"kernel J {name} count {k}")
        again, c2 = DJ.detect_kernel(dsp, masks, counts, cfg)
        for f in FIELDS:
            same(getattr(again, f), getattr(kp, f), f"kernel J {name} {f}, two launches")
        bsz = len(files)
        valid = int(c["extrema"].clamp_max(cfg.extrema_cap).sum())
        rows = sum(cn.numel() for cn in counts)
        t_bytes = (rows * 4 + sum(int((cn > 0).sum()) for cn in counts) * 128 * 4
                   + valid * DETECT_LANE_BYTES
                   + bsz * cfg.kp_cap * (6 * 4 + 1 + 128)) / HBM_BPS * 1e3
        call = lambda: DJ.detect_kernel(dsp, masks, counts, cfg)  # noqa: E731
        out[name] = dict(
            frames=bsz, lanes=bsz * cfg.extrema_cap, valid=valid,
            extrema=c["extrema"].tolist(), refined=c["refined"].tolist(),
            refine_active=c["refine_active"].tolist(),
            ms=cuda_ms(call, KERNEL_REPS), device_ms=graph_ms(call, KERNEL_REPS),
            plain_ms=host_ms(plain, 3), bound_ms=t_bytes, bound_by="bytes", max_abs_err=err)
        del dsp, masks, counts, kp, want, again
    emit(dict(phase="detect_kernel", nvidia_smi=smi, bit_equal_to_plain_chain=True, cells=out))
    return out


def wide_frames(rows=None):
    """Frames A and B of phase ``wide_fallback``: CAVE-01 scene frames 00-15
    and 01-16 (tests/data/scene_oracle, the oracle-decoded pixels), each set
    side by side, (2, 480, 10240, 3) uint8; ``rows``: only the first rows."""
    import numpy as np

    f = [np.load(DATA / "scene_oracle" / f"cave01_{i:02d}.npz")["input"][:rows]
         for i in range(WIDE_FRAMES + 1)]
    return np.stack([np.concatenate(f[:WIDE_FRAMES], 1), np.concatenate(f[1:], 1)])


def wide_fallback_phase(dev, frames, zero_counts, read_counts, honest):
    """Phase ``wide_fallback``: the two wide frames (``wide_frames``)
    through the entry point, where the plan sends octave 0 (wider than
    kernel F takes) through the fallback on its own: kernel A, the
    ``twin_strided`` relayout and kernel G.  Gates: (1) the plan: octave 0
    alone does not fit, at WIDE_PLAN0; (2) launches through
    ``detect_and_describe_batch`` + ``match_descriptors``: A 1, G 1, F one
    an octave after 0, D 1, B 1, C / E / H 0; (3) keypoints, descriptors,
    stage counts and the match set bit-equal to the front route (kernel A
    on every octave); (4) both gather buffers bit-equal to the same plan
    with octave 0 forced through kernel F at its strip, and so the route's
    outputs; (5) kernel G on the wide stack into a NaN-filled buffer
    against its plain version, rows outside its region untouched; (6) the
    path's other kernels against their plain versions on its inputs, bit
    for bit: D on the doubled grey image, A on the initial image, F on
    octaves 1-7 into the plan's buffers, B on the pair's descriptors (the
    matcher's own outputs).  True stage counts must fit WIDE_CAPS.  Then
    the entry point's and the front route's sweeps in turns, the fallback
    octave's pieces by CUDA events, each beside its bound, and peak memory
    (the path with gates 1-5; gate 6 with the timings).  Returns (the entry point's
    launches, kernel G's numbers at the wide stack, gate 5 and 6's max
    |kernel - plain| by kernel)."""
    import torch

    from sift_tpu_torch import SiftConfig, match_descriptors
    from sift_tpu_torch.config import gaussian_half_kernel
    from sift_tpu_torch.models import sift as S
    from sift_tpu_torch.models.pyramid import blur_half_kernels, compute_initial_image
    from sift_tpu_torch.ops.blur import separable_blur
    from sift_tpu_torch.ops.blur_pass import separable_blur_kernel
    from sift_tpu_torch.ops.color import to_grayscale
    from sift_tpu_torch.ops.cube_pack import cube_pack_rows
    from sift_tpu_torch.ops.gather import cube_rows_plain, twin_strided
    from sift_tpu_torch.ops.octave_front import (
        front_twin_strip,
        octave_front,
        octave_front_plain,
        octave_front_twin,
        octave_front_twin_plain,
    )
    from sift_tpu_torch.ops.resize import downsample_nearest_x2, upsample_bilinear
    from sift_tpu_torch.ops.top2 import top2_plain
    from sift_tpu_torch.utils.keypoints import FIELDS

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = SiftConfig(**WIDE_CAPS)
    need(S.route_of(cfg, dev) == "front_twin", "wide frames: not the front-twin route")
    imgs = S.as_batch(frames, cfg, dev)
    octs = S.octaves_for(imgs, cfg)
    h0, w0 = 2 * imgs.shape[1], 2 * imgs.shape[2]

    # Gate 1: the plan the entry point takes.
    plan = S.front_twin_plan(cfg, octs, h0, w0)
    fits = [o[3] for o in plan.octaves]
    need(fits == [False] + [True] * (octs - 1), f"wide plan: octaves that fit {fits}")
    st0, pb0 = plan.octaves[0][2], plan.pk_bases[0]
    need((st0, plan.pk_nbps[0]) == WIDE_PLAN0,
         f"wide plan octave 0: strip {st0}, {plan.pk_nbps[0]} packed blocks")

    def match(kp):
        return match_descriptors(kp.desc[0:1], kp.valid[0:1], kp.desc[1:2], kp.valid[1:2],
                                 cfg.ratio_threshold, device=dev)

    # Gate 2: the entry point and the matcher, counted.
    zero_counts()
    kp, counts = S.detect_and_describe_batch(imgs, cfg, return_counts=True, device=dev)
    idx, acc, best, second = match(kp)
    launches = read_counts()
    want = dict(octave_front=1, cube_pack=1, octave_front_twin=octs - 1, blur_pass=1, top2=1,
                octave_blur=0, twin_rows=0, twin_rows_2d=0, detect=1, orient=1)
    need({k: launches[k] for k in want} == want, f"wide_fallback: launches {launches}, want {want}")
    honest(kp, counts, "wide frames", cfg)
    nkp = kp.valid.sum(1).tolist()
    need(min(nkp) > 0 and int(acc.sum()) > 0, f"wide frames: {nkp} keypoints, "
         f"{int(acc.sum())} matches")

    # Gate 3: the front route on the same frames.
    kf, cf = S.run_route(imgs, cfg, "front")
    idx_f, acc_f, _, _ = match(kf)
    for f in FIELDS:
        same(getattr(kp, f), getattr(kf, f), f"wide frames {f}: entry point vs front route")
    for k in counts:
        same(torch.as_tensor(counts[k]), torch.as_tensor(cf[k]),
             f"wide frames count {k}: entry point vs front route")
    same(acc, acc_f, "wide frames: accepted matches vs front route")
    same(idx[acc], idx_f[acc_f], "wide frames: match set vs front route")
    del kf, cf, idx_f, acc_f

    # Gate 4: octave 0 through kernel F at the same strip; the plan's
    # numbers, so the layout, are the same.
    fplan = S.front_twin_plan(
        cfg, octs, h0, w0,
        strip_fn=lambda shape, *a: st0 if tuple(shape) == (h0, w0) else front_twin_strip(shape, *a))
    need([o[3] for o in fplan.octaves] == [True] * octs
         and [o[:3] + o[4:] for o in fplan.octaves] == [o[:3] + o[4:] for o in plan.octaves]
         and (fplan.g_total, fplan.unit, fplan.pk_bases, fplan.pk_total)
         == (plan.g_total, plan.unit, plan.pk_bases, plan.pk_total),
         "wide plan with octave 0 through kernel F: another layout")
    ga, da, ma, ca = S.front_twin(imgs, cfg)
    gf, df, mf, cf_ = S.front_twin(imgs, cfg, fplan)
    same(ga.rows, gf.rows, "wide gauss twin rows: fallback octave 0 vs kernel F at its strip")
    same(da.rows, df.rows, "wide packed DoG rows: fallback octave 0 vs kernel F at its strip")
    for o in range(octs):
        same(ma[o], mf[o], f"wide octave {o} mask: fallback vs kernel F")
        same(ca[o], cf_[o], f"wide octave {o} counts: fallback vs kernel F")
    del ga, da, ma, ca, gf, df, mf, cf_
    zero_counts()
    kF, cF = S.run_route(imgs, cfg, "front_twin", fplan)
    f_launches = read_counts()
    need((f_launches["octave_front_twin"], f_launches["octave_front"], f_launches["cube_pack"],
          f_launches["detect"]) == (octs, 0, 0, 1),
         f"wide frames through kernel F: launches {f_launches}")
    for f in FIELDS:
        same(getattr(kp, f), getattr(kF, f), f"wide frames {f}: fallback vs kernel F")
    for k in counts:
        same(torch.as_tensor(counts[k]), torch.as_tensor(cF[k]), f"wide count {k}: vs kernel F")
    del kF, cF

    # Gate 5: kernel G alone on the wide stack, NaN-filled buffer.
    hks = blur_half_kernels(cfg)
    thr = cfg.extremum_threshold()
    initial = compute_initial_image(imgs, cfg)
    g0, d0, m0, c0 = octave_front(initial, hks, thr)
    d_shape = list(d0.shape)
    g_err = check_cube_launch([d0], [st0], [pb0], plan.pk_total, "kernel G wide stack")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # Gate 6: the path's other launches against their plain versions on the
    # same inputs.  B's plain version runs 4,096 rows of the first image's
    # descriptors at a time (rows are independent), so its (N, M) distance
    # matrices stay small.
    torch.cuda.reset_peak_memory_stats()
    errs = {}
    pre = gaussian_half_kernel(math.sqrt(cfg.init_sigma * cfg.init_sigma - 1))
    gray = upsample_bilinear(to_grayscale(imgs).to(cfg.dtype), 2, 2).contiguous()
    d_k = separable_blur_kernel(gray, pre)
    errs["blur_pass"] = same(d_k, separable_blur(gray, pre), "kernel D wide initial vs plain")
    same(d_k, initial, "kernel D wide initial vs the path's seed")
    del gray, d_k
    errs["octave_front"] = max(
        same(a, b, f"kernel A wide octave 0 {name} vs plain") for name, a, b in
        zip(("gauss", "dog", "mask", "counts"), (g0, d0, m0, c0),
            octave_front_plain(initial, hks, thr)))
    del m0, c0
    bufs = [(torch.zeros((imgs.shape[0], plan.g_total, 2 * plan.blk), device=dev),
             torch.zeros((imgs.shape[0], plan.pk_total, 128), device=dev)) for _ in range(2)]
    seed, f_err = downsample_nearest_x2(g0[:, g0.shape[1] - 3]).contiguous(), 0.0
    for o in range(1, octs):
        (_, _, st, _, _, gb), pkb = plan.octaves[o], plan.pk_bases[o]
        got, ref = [fn(seed, hks, thr, gbuf, gb, st, plan.blk, plan.g_l0, plan.g_nl, pkbuf, pkb)
                    for fn, (gbuf, pkbuf) in zip((octave_front_twin, octave_front_twin_plain),
                                                 bufs)]
        for name, a, b in zip(("mask", "counts", "down"), got, ref):
            f_err = max(f_err, same(a, b, f"kernel F wide octave {o} {name} vs plain"))
        seed = downsample_nearest_x2(got[2]).contiguous()
    f_err = max(f_err, same(bufs[0][0], bufs[1][0], "kernel F wide gauss twin rows vs plain"),
                same(bufs[0][1], bufs[1][1], "kernel F wide cube-packed rows vs plain"))
    errs["octave_front_twin"] = f_err
    del bufs, seed, got, ref
    x1, x2, v2 = kp.desc[0:1], kp.desc[1:2], kp.valid[1:2]
    ref = [torch.cat(part, 1) for part in zip(*(top2_plain(x1[:, i: i + 4096], x2, v2)
                                                for i in range(0, x1.shape[1], 4096)))]
    errs["top2"] = max(same(a[0], b[0], f"kernel B wide descriptors {name} vs plain")
                       for name, a, b in zip(("best", "second", "idx"),
                                             (best, second, idx), ref))
    del ref
    errs["cube_pack"] = g_err

    # The sweeps in turns (entry point, front, front, entry point).
    def sweep(route):
        out = (S.detect_and_describe_batch(imgs, cfg, device=dev) if route is None
               else S.run_route(imgs, cfg, route)[0])
        match(out)

    turns = [host_ms(lambda r=r: sweep(r), WIDE_SWEEPS) for r in (None, "front", "front", None)]

    # The fallback octave's pieces, each beside its byte bound.
    a_ms = cuda_ms(lambda: octave_front(initial, hks, thr), 5)
    gbase = plan.octaves[0][5]
    grows = torch.zeros((imgs.shape[0], plan.g_total, 2 * plan.blk), device=dev)
    gt_rows = twin_strided(g0, plan.blk, st0, plan.g_l0, plan.g_nl).shape[1]

    def relayout():
        grows[:, gbase: gbase + gt_rows] = twin_strided(g0, plan.blk, st0, plan.g_l0, plan.g_nl)

    ts_ms = cuda_ms(relayout, 5)
    pk = torch.zeros((imgs.shape[0], plan.pk_total, 128), device=dev)
    g_ms = cuda_ms(lambda: cube_pack_rows(d0, st0, out=pk, base=pb0), KERNEL_REPS)
    g_plain_ms = cuda_ms(lambda: cube_rows_plain(d0, st0), 3)
    dp = cube_padded(d0, st0)
    lib = torch.zeros_like(pk)
    same(library_cube(dp, st0, lib, pb0), pk, "kernel G's library yardstick vs the kernel, wide")
    del lib
    g_lib_ms = cuda_ms(lambda: library_cube(dp, st0, pk, pb0), KERNEL_REPS)
    n_rows = -(-h0 // st0) * st0 * plan.pk_nbps[0]
    g_bound = bound(*twin_bound(d0.numel(), imgs.shape[0] * n_rows * 128))
    ts_bound = twin_bound(imgs.shape[0] * plan.g_nl * h0 * w0,
                          imgs.shape[0] * gt_rows * 2 * plan.blk)
    a_bound = bound(*octave_bound([(h0, w0)], imgs.shape[0], hks, mask=True))
    peak_after = torch.cuda.max_memory_allocated() / 2**30
    emit(dict(phase="wide_fallback", frames_hw=list(imgs.shape[1:3]), doubled_hw=[h0, w0],
              octaves=octs, batch=int(imgs.shape[0]), caps=WIDE_CAPS,
              octave0=dict(strip=st0, packed_blocks=plan.pk_nbps[0], fits=False),
              strips=[o[2] for o in plan.octaves], keypoints=nkp, matches=int(acc.sum()),
              counts={k: v.tolist() for k, v in counts.items()}, launches=launches,
              equal_to_front_route=True, buffers_equal_to_kernel_f=True,
              route_equal_to_kernel_f=True, kernel_f_launches=f_launches,
              kernel_g_nan_filled_bit_equal=True, kernels_vs_plain_bit_equal=True,
              max_abs_err=errs, top2_shape=[int(x1.shape[1]), int(x2.shape[1])],
              sweep_ms_turns=dict(entry_point=[turns[0], turns[3]], front_route=turns[1:3]),
              sweeps_per_turn=WIDE_SWEEPS,
              fallback_octave_ms=dict(
                  octave_front=a_ms, octave_front_bound=a_bound[0],
                  twin_strided_and_copy=ts_ms, twin_strided_and_copy_bound=ts_bound[0],
                  cube_pack=g_ms, cube_pack_bound=g_bound[0]),
              cube_pack_plain_ms=g_plain_ms, cube_pack_library_ms=g_lib_ms,
              peak_mem_gib=max(peak, peak_after), peak_mem_gib_path_and_gates_1_5=peak,
              peak_mem_gib_gate_6_and_timings=peak_after, phase_s=time.perf_counter() - t_phase))
    del imgs, initial, g0, d0, grows, pk, dp
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return launches, dict(ms=g_ms, plain_ms=g_plain_ms, library_ms=g_lib_ms, bound_ms=g_bound[0],
                          bound_by=g_bound[1], shape=d_shape), errs


def run_tool(args, what):
    """``python3 scripts/<args>`` from the repository's root as a user runs
    it: (its JSON lines, wall seconds); a non-zero exit fails the run."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / args[0]), *args[1:]], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    need(proc.returncode == 0, f"{what} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")], wall


MATCH_SWEEP = (2048, 8192, 16384, 32768)  # scripts/bench_match_ab.py's sizes
TOOL_REPS = 5


def jax_tool_scripts():
    """The port's counterparts of the JAX package's last four tool scripts,
    each run on the card as a user runs it and held to its gates:

    * ``torch_bench_match_ab.py --reps 5``: a ``kernel`` line with kernel
      B launched at each of ``MATCH_SWEEP``; ``kernel`` bit-equal to
      ``plain`` (idx, accept, best, second) at 4096 and at every size
      where ``plain`` ran; a ``plain`` or ``library`` size that failed
      failed for the card's memory, and is named.
    * ``torch_perf_breakdown.py --reps 5 --out FILE``: every row of the JAX
      script, finite; the stage chain's keypoints bit-equal to
      ``detect_and_describe_batch`` on the same 8 frames; kernels A, C, D,
      E, F and B launched; the table headed by the card's name and power
      limit.
    * ``torch_sfm_ablate.py``: sweep-16 and loop-15 with verification off
      and on, finite metrics; D once and F once an octave for every frame,
      B once a pair.
    * ``torch_sfm_pgo_debug.py``: the base, after-PGO and after-refine-BA
      metrics finite, at least one closure pair, the refine BA registering
      at least the base solve's frames.

    Returns (the phase line's record, the scripts' launches summed)."""
    import numpy as np

    from sift_tpu_torch import SiftConfig

    def finite(rec, keys):
        return all(np.isfinite(rec[k]) for k in keys)

    lines, match_s = run_tool(["torch_bench_match_ab.py", "--reps", str(TOOL_REPS)],
                              "the matcher sweep")
    timed = [r for r in lines if "path" in r]
    kern = {r["n"]: r for r in timed if r["path"] == "kernel"}
    need(sorted(kern) == list(MATCH_SWEEP) and all(r["launches"] > 0 and "error" not in r
                                                   for r in kern.values()),
         f"the matcher sweep's kernel lines: {kern}")
    errors = [r for r in timed if "error" in r]
    failed = [(r["n"], r["path"]) for r in errors]
    need(all(r["path"] in ("plain", "library") and r["error"].startswith("OutOfMemoryError")
             for r in errors), f"the matcher sweep: a failure other than the card's memory: {errors}")
    ran_plain = sorted(r["n"] for r in timed if r["path"] == "plain" and "error" not in r)
    agree = lines[-1]
    need(agree.get("agreement_4096") is True
         and all(agree["agreement"].get(str(n)) is True for n in ran_plain),
         f"the matcher sweep's agreement {agree}, plain ran at {ran_plain}")
    bounds = {r["n"]: r for r in lines if "bound_ms" in r}
    sweep = {str(n): dict(launches=kern[n]["launches"], bound_ms=bounds[n]["bound_ms"],
                          bound_by=bounds[n]["bound_by"], kernel_min_ms=kern[n]["min_ms"],
                          **{f"{r['path']}_ms": r.get("median_ms") for r in timed if r["n"] == n})
             for n in MATCH_SWEEP}

    bd = port_script("torch_perf_breakdown")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "breakdown.md"
        lines, bd_s = run_tool(["torch_perf_breakdown.py", "--reps", str(TOOL_REPS), "--out",
                                str(out)], "the stage breakdown")
        table = out.read_text()
    rows = [r for r in lines if "row" in r]
    summary = next(r for r in lines if "chain_equal_entry_point" in r)
    total = lines[-1]
    need([r["jax_row"] for r in rows if r["jax_row"]] == bd.jax_rows(8)
         and all(finite(r, ("median_ms", "min_ms")) for r in rows),
         f"the breakdown's rows: {[(r['row'], r['median_ms']) for r in rows]}")
    need(summary["chain_equal_entry_point"] is True and summary["route"] == "front_twin",
         f"the breakdown's stage chain against the entry point: {summary}")
    bl = summary["launches"]
    need(all(bl[k] > 0 for k in ("octave_front", "octave_blur", "blur_pass", "twin_rows",
                                 "octave_front_twin", "top2")), f"the breakdown's launches {bl}")
    need(total.get("batch") == 8 and np.isfinite(total["stage_total_ms_median"]),
         f"the breakdown's last line {total}")
    need(table.startswith(f"# PERF — per-stage breakdown ({smi_line()})") and "TPU" not in table,
         f"the breakdown's table header: {table.splitlines()[0]}")

    s_oct = SiftConfig(**SFM_CAPS).octaves_count(2 * 320, 2 * 240)
    recs, ablate_s = run_tool(["torch_sfm_ablate.py"], "the SfM ablation")
    need([(r["seq"], r["verify"]) for r in recs]
         == [("sweep-16", "off"), ("sweep-16", "on"), ("loop-15", "off"), ("loop-15", "on")],
         f"the SfM ablation's lines {[(r['seq'], r['verify']) for r in recs]}")
    metric_keys = ("ate_rmse_m", "rpe_rmse_m", "ate_pct_of_path")
    for r in recs:
        got = r["launches"]
        need(finite(r, metric_keys), f"the SfM ablation's metrics: {r}")
        need(got["blur_pass"] == r["frames"] and got["octave_front_twin"] == s_oct * r["frames"]
             and got["top2"] == r["pairs"], f"the SfM ablation's launches, {r['seq']}: {got}")

    lines, pgo_s = run_tool(["torch_sfm_pgo_debug.py"], "the loop-closure debug")
    stages = {r["stage"]: r for r in lines}
    base, pgo, refine = (stages[k] for k in ("base", "after PGO", "after refine BA"))
    need(all(finite(r, metric_keys) for r in (base, pgo, refine)),
         f"the loop-closure debug's metrics: {base}, {pgo}, {refine}")
    need(len(stages["closures"]["closures"]) >= 1,
         f"the loop-closure debug found no closure: {stages['closures']}")
    need(refine["registered"] >= base["registered"],
         f"the refine BA registered {refine['registered']}, the base {base['registered']}")

    launches = {k: bl[k] + refine["launches"][k]
                + sum(r["launches"][k] for r in recs[::2])  # a sequence's, on both its lines
                + sum(r["sfm_launches"][k] for r in recs) for k in bl}
    launches["top2"] += sum(r["launches"] for r in kern.values())
    rec = dict(
        match_ab=dict(command=f"scripts/torch_bench_match_ab.py --reps {TOOL_REPS}",
                      wall_s=match_s, sizes=sweep, failed=failed, agreement=agree["agreement"]),
        breakdown=dict(command=f"scripts/torch_perf_breakdown.py --reps {TOOL_REPS} --out FILE",
                       wall_s=bd_s, rows={r["row"]: [r["median_ms"], r["min_ms"]] for r in rows},
                       stage_total_ms_median=total["stage_total_ms_median"],
                       frames_per_s_equiv=summary["frames_per_s_equiv"],
                       keypoints=summary["keypoints"], capacities=summary["capacities"],
                       chain_equal_entry_point=True, launches=bl),
        ablate=dict(command="scripts/torch_sfm_ablate.py", wall_s=ablate_s,
                    lines=[{k: r[k] for k in ("seq", "verify", "frames", "registered", "pairs",
                                              "ate_pct_of_path", "rpe_rmse_m", "seconds",
                                              "points", "obs", "pruned", "launches")}
                           for r in recs]),
        pgo_debug=dict(command="scripts/torch_sfm_pgo_debug.py", wall_s=pgo_s,
                       frames=base["frames"], closures=stages["closures"]["closures"],
                       candidates=len(stages["closures"]["candidates"]),
                       stages={k: {f: r.get(f) for f in ("ate_pct_of_path", "rpe_rmse_m",
                                                         "registered", "points", "pruned",
                                                         "seconds")}
                               for k, r in (("base", base), ("after PGO", pgo),
                                            ("after refine BA", refine))},
                       launches=refine["launches"]))
    return rec, launches


def tools_phase(dev, smi, scene_kp, chain_n, octaves, zero_counts, read_counts):
    """Phase ``tools``: the port's three evaluation scripts on the card as a
    user runs them, each held to what the earlier phases established.

    * ``torch_verify_scene_parity.py --caps <SCENE_CAPS> --provenance``:
      the bench-capacity anchor is the exact 165-match set; every frame's
      keypoints and every chain edge's matches equal the stitch phase's
      (``scene_kp``, ``chain_n``: the same frames and capacities through
      the entry point at batch 1); every non-exact edge's differing matches
      are classified; launches D 1 + 5 batches, F 8 a batch, B 1 + 34.
    * ``torch_sfm_eval.py --frames 8 --out FILE``: the four sequences'
      lines and the table; sweep-8 registers all 8 frames; D once and F
      once an octave for every frame, B on every matched pair.
    * ``torch_bench_scaling.py`` at world size 1: a well-formed line, no
      clipped count, frame 0's keypoints bit-equal (SHA-256 of every field
      of the valid lanes) to a direct ``detect_fn`` call in this process,
      and the rank's launches of kernels D and H those of the direct call
      for each of its frames.

    Returns the launches of the scripts' runs, summed (the scaling rank's
    first iteration)."""
    import numpy as np
    import torch

    from sift_tpu_torch import SiftConfig
    from sift_tpu_torch.models.sift import detect_fn

    t_phase = time.perf_counter()
    c = SiftConfig(**SCENE_CAPS)
    caps = f"{c.extrema_cap},{c.kp_cap},{c.ori_cap}"
    lines, audit_s = run_tool(["torch_verify_scene_parity.py", "--caps", caps, "--provenance"],
                              "the scene audit")
    anchor, summary = lines[0], lines[-1]
    need(anchor.get("set_exact") is True and anchor["matches"] == WANT_MATCHES,
         f"the audit's bench-caps anchor: {anchor}")
    frames = [r for r in lines if "frame" in r]
    edges = [r for r in lines if "edge" in r]
    need([r["frame"] for r in frames] == list(range(SCENE_FRAMES))
         and [r["mine"] for r in frames] == scene_kp,
         f"the audit's keypoints {[r['mine'] for r in frames]}, the stitch phase's {scene_kp}")
    need([r["edge"] for r in edges] == [[i, i + 1] for i in range(SCENE_FRAMES - 1)]
         and [r["matches"] for r in edges] == chain_n,
         f"the audit's chain matches {[r['matches'] for r in edges]}, the stitch phase's {chain_n}")
    need(summary.get("summary") and summary["graph"] == "chain"
         and (summary["frames"], summary["edges"]) == (SCENE_FRAMES, SCENE_FRAMES - 1),
         f"the audit's summary: {summary}")
    kinds = {"kp-miss": 0, "ratio-flip": 0}
    for r in edges:
        if r["set_exact"]:
            continue
        prov = r.get("provenance")
        need(prov is not None and all(e["kind"] in kinds for e in prov)
             and sum(e["side"] == "ref-only" for e in prov) == r["ref_matches"] - r["overlap"]
             and all(isinstance(e.get("margin"), int) for e in prov if e["kind"] == "ratio-flip"),
             f"edge {r['edge']}: differing matches not all classified: {r}")
        for e in prov:
            kinds[e["kind"]] += 1
    batches = -(-SCENE_FRAMES // 8)
    want = dict(blur_pass=1 + batches, octave_front_twin=octaves * (1 + batches),
                top2=1 + SCENE_FRAMES - 1)
    need({k: summary["launches"][k] for k in want} == want,
         f"the audit's launches {summary['launches']}, want {want}")

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "sfm.md"
        recs, sfm_s = run_tool(["torch_sfm_eval.py", "--frames", "8", "--out", str(out)],
                               "the SfM harness")
        table = out.read_text().splitlines()
    names = ["sweep-8", "loop-7", "bigloop-13", "bigloop-13-noclosure"]
    need([r["seq"] for r in recs] == names, f"the SfM harness's sequences {[r['seq'] for r in recs]}")
    need(recs[0]["registered"] == recs[0]["frames"] == 8,
         f"sweep-8: {recs[0]['registered']} of 8 frames registered")
    need(all(np.isfinite(r[k]) for r in recs for k in ("ate_rmse_m", "rpe_rmse_m", "ate_pct_of_path")),
         f"the SfM harness's metrics: {recs}")
    need(table[3].startswith("| sequence | frames | ATE-RMSE")
         and [ln.split(" | ")[0][2:] for ln in table[5:9]] == names, f"the SfM table: {table}")
    s_oct = SiftConfig(**SFM_CAPS).octaves_count(2 * 320, 2 * 240)
    for r in recs:
        got = r["launches"]
        need(got["blur_pass"] == r["frames"] and got["octave_front_twin"] == s_oct * r["frames"]
             and got["top2"] > 0, f"{r['seq']}: launches {got}")

    lines, scaling_s = run_tool(["torch_bench_scaling.py"], "the scaling harness")
    line = lines[-1]
    sc = port_script("torch_bench_scaling")
    h, w = line["size"]
    row = line["scaling"][0]
    need(line["mode"] == "cuda" and [r["devices"] for r in line["scaling"]]
         == sc.sizes_upto(torch.cuda.device_count())
         and row["frames_per_s"] > 0 and row["efficiency"] == 1.0 and line["clipped"] == []
         and len(row["keypoints_sha256"]) == line["per_device_batch"],
         f"the scaling line: {line}")
    cfg = sc.config_for(h, w)
    zero_counts()
    kp = detect_fn(sc.images(1, h, w)[0], cfg, cfg.octaves_count(2 * w, 2 * h), device=dev)
    direct = read_counts()
    need(sc.keypoints_digest(kp) == row["keypoints_sha256"][0]
         and int(kp.valid.sum()) == row["keypoints"][0],
         f"scaling frame 0: {row['keypoints'][0]} keypoints, a direct detect_fn call "
         f"{int(kp.valid.sum())}; digests {row['keypoints_sha256'][0]} / {sc.keypoints_digest(kp)}")
    pdb = line["per_device_batch"]
    need(direct["blur_pass"] > 0 and direct["twin_rows_2d"] > 0
         and all(row["launches"][k] == pdb * direct[k] for k in ("blur_pass", "twin_rows_2d")),
         f"scaling launches: rank {row['launches']}, a direct call {direct}")

    scripts, script_launches = jax_tool_scripts()
    launches = {k: summary["launches"][k] + sum(r["launches"][k] for r in recs)
                + row["launches"][k] + script_launches[k] for k in summary["launches"]}
    emit(dict(phase="tools", nvidia_smi=smi,
              audit=dict(command=f"scripts/torch_verify_scene_parity.py --caps {caps} --provenance",
                         wall_s=audit_s, anchor=anchor, summary=summary,
                         keypoints_equal_stitch_phase=True, chain_matches_equal_stitch_phase=True,
                         non_exact_edges=[r["edge"] for r in edges if not r["set_exact"]],
                         differing_matches=kinds, overlap=sum(r["overlap"] for r in edges),
                         ref_matches=sum(r["ref_matches"] for r in edges)),
              sfm=dict(command="scripts/torch_sfm_eval.py --frames 8 --out FILE", wall_s=sfm_s,
                       sequences=[{k: r[k] for k in ("seq", "frames", "registered", "ate_rmse_m",
                                                     "ate_pct_of_path", "rpe_rmse_m", "seconds",
                                                     "launches")} for r in recs],
                       table_rows=len(names)),
              scaling=dict(command="scripts/torch_bench_scaling.py", wall_s=scaling_s, line=line,
                           frame0_bit_equal_detect_fn=True, direct_launches=direct),
              **scripts, launches=launches, phase_s=time.perf_counter() - t_phase))
    return launches


def main() -> int:
    t_script = time.perf_counter()
    import numpy as np
    import torch
    from PIL import Image as PILImage

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
    from sift_tpu_torch.config import gaussian_half_kernel
    from sift_tpu_torch.models import sift as S
    from sift_tpu_torch.models.match import ratio_accept
    from sift_tpu_torch.models.pyramid import blur_half_kernels, compute_initial_image
    from sift_tpu_torch.ops.blur import separable_blur
    from sift_tpu_torch.ops.blur_pass import launch_plan as blur_plan
    from sift_tpu_torch.ops.blur_pass import separable_blur_kernel
    from sift_tpu_torch.ops.blur_pass import strip_rows_for as blur_strip_rows
    from sift_tpu_torch.ops.color import to_grayscale
    from sift_tpu_torch.models.pyramid import front_twin_pyramids
    from sift_tpu_torch.ops.cube_pack import cube_pack_rows
    from sift_tpu_torch.ops.gather import StackSpace, build_multi_rows, cube_rows_plain
    from sift_tpu_torch.ops.octave_blur import octave_blur, octave_blur_plain
    from sift_tpu_torch.ops.octave_front import (
        front_twin_strip,
        octave_front,
        octave_front_plain,
        octave_front_twin,
        octave_front_twin_plain,
    )
    from sift_tpu_torch.ops.octave_rolling import batch_rows_for
    from sift_tpu_torch.ops.resize import downsample_nearest_x2, upsample_bilinear
    from sift_tpu_torch.ops.top2 import split_for as top2_split_for
    from sift_tpu_torch.ops.top2 import top2, top2_plain
    from sift_tpu_torch.ops.twin_rows import (
        twin_rows_2d,
        twin_rows_2d_plain,
        twin_rows_strips,
        twin_rows_strips_plain,
    )
    from sift_tpu_torch import cli
    from sift_tpu_torch.models.descriptor import class_counts as desc_class_counts
    from sift_tpu_torch.models.descriptor import compute_descriptors_plain, desc_radius_classes
    from sift_tpu_torch.models.orient import class_counts as ori_class_counts
    from sift_tpu_torch.models.orient import ori_radius_classes, orient_plain
    from sift_tpu_torch.models import blend as BL
    from sift_tpu_torch.models import stitch as ST
    from sift_tpu_torch.models.cylindrical import stitch_scene_cylindrical
    from sift_tpu_torch.utils import native
    from sift_tpu_torch.utils.stitch_graph import StitchGraph, chain_graph
    from sift_tpu_torch.utils.io import save_image
    from sift_tpu_torch.utils.keypoints import FIELDS, compact
    from sift_tpu_torch.utils.profiling import StageTimer

    dev = torch.device("cuda")
    smi = smi_line()
    zero_counts = kernels.reset_launch_counts

    def read_counts():
        torch.cuda.synchronize()
        return kernels.launch_counts()

    # -- phase 1: device and kernel build ---------------------------------
    t0 = time.perf_counter()
    logs = kernels.build(["octave_front", "top2", "blur_pass", "twin_rows", "cube_pack",
                          "describe", "detect"])
    build_s = time.perf_counter() - t0
    # ptxas's register / spill report of each kernel (empty when cached).
    ptxas = {k: [ln.split(":", 1)[-1].strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln or "stack frame" in ln]
             for k, v in logs.items()}
    # Kernel D's taps are fixed at build time: no stack frame, no spills.
    if logs["blur_pass"] != "cached":
        frames = [ln for ln in ptxas["blur_pass"] if "stack frame" in ln]
        need(len(frames) >= 16 and all(ln.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                                    "0 bytes spill loads") for ln in frames),
             f"kernel D: stack frame or spills: {frames}")
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
    octaves = S.octaves_for(imgs, cfg)
    hks = blur_half_kernels(cfg)
    thr = cfg.extremum_threshold()

    # -- phase 2: kernel A vs its plain version at every octave shape ------
    seeds = [compute_initial_image(imgs, cfg).contiguous()]
    shapes = []
    worst = 0.0
    for o in range(octaves):
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
    # A chain whose rings do not fit shared memory at the full row batch
    # (4 intervals: 6 blurs) makes the launcher take a smaller one.
    cfg4 = SiftConfig(intervals=4, **CAPS)
    hks4 = blur_half_kernels(cfg4)
    radii4 = [len(hk) - 1 for hk in hks4]
    need(batch_rows_for(radii4, True) < batch_rows_for([len(hk) - 1 for hk in hks], True),
         "the 4-interval chain does not force a smaller batch")
    for o in (0, 2, 5):
        sd = seeds[o]
        for what, got, ref in (
                ("A", octave_front(sd, hks4, thr), octave_front_plain(sd, hks4, thr)),
                ("C", octave_blur(sd, hks4), octave_blur_plain(sd, hks4))):
            for a, b in zip(got, ref):
                same(a, b, f"kernel {what} octave {o}, 4-interval chain, vs plain")
        del got, ref
    read_x, work_x, strips_a, ctas_a = front_halo_cost(shapes, hks, BATCH, mask=True)
    a_times = octave_bound(shapes, BATCH, hks, mask=True)
    emit(dict(phase="kernel_a_vs_plain", shapes_hw=shapes, batch=BATCH,
              bit_equal=True, max_abs_err=worst, seed_read_factor=read_x,
              blur_work_factor=work_x, strip_rows=strips_a, ctas=ctas_a,
              smaller_batch_chain=dict(intervals=4, radii=radii4, octaves=[0, 2, 5],
                                       batch_rows=batch_rows_for(radii4, True), bit_equal=True),
              bytes_ms=a_times[0], ops_ms=a_times[1]))

    def chain(fn):
        return lambda: [fn(s, hks, thr) for s in seeds]

    a_ms = cuda_ms(chain(octave_front), KERNEL_REPS)
    a_plain_ms = cuda_ms(chain(octave_front_plain), 3)
    a_bound, a_by = bound(*a_times)

    # -- phase 3: kernel C vs its plain version and kernel A, and kernel D
    # vs its plain version on every blur of the chain, every octave shape --
    # C at batch 16 (the non-front route's shapes) and per frame (1, H, W)
    # (the staged path's); the batch's pyramid stays for kernel E's check.
    c_err = d_err = 0.0
    d_checked = []

    def d_plan(shape, hk):
        """Kernel D's launch plan at ``shape`` (strip rows, CTAs an SM, SMs),
        which the CPU model's strip rule must reproduce."""
        strip, ctas, sms = blur_plan(*shape, len(hk))
        need(strip == blur_strip_rows(*shape, len(hk) - 1, ctas, sms),
             f"kernel D strip rule at {shape}, {len(hk)} taps: the launcher takes {strip}")
        return dict(strip_rows=strip, ctas_per_sm=ctas, sms=sms)

    gs16, ds16 = [], []
    for o, seed in enumerate(seeds):
        ref = octave_blur_plain(seed, hks)
        got = octave_blur(seed, hks)
        front = octave_front(seed, hks, thr)[:2]
        torch.cuda.synchronize()
        for name, a, b, f in zip(("gauss", "dog"), got, ref, front):
            c_err = max(c_err, same(a, b, f"kernel C octave {o} {name} vs plain"))
            c_err = max(c_err, same(a, f, f"kernel C octave {o} {name} vs kernel A"))
        for i in range(2):
            one = seed[i: i + 1].contiguous()
            for name, a, b in zip(("gauss", "dog"), octave_blur(one, hks),
                                  octave_blur_plain(one, hks)):
                c_err = max(c_err, same(a, b, f"kernel C frame {i} octave {o} {name} vs plain"))
        for k, hk in enumerate(hks):
            layer = ref[0][:, k].contiguous()
            d_err = max(d_err, same(separable_blur_kernel(layer, hk), separable_blur(layer, hk),
                                    f"kernel D octave {o} blur {k + 1} vs plain"))
            d_checked.append(dict(octave=o, blur=k + 1, taps=len(hk),
                                  **d_plan(tuple(layer.shape), hk)))
        gs16.append(got[0])
        ds16.append(got[1])
        del ref, got, front
    c_times = octave_bound(shapes, BATCH, hks, mask=False)
    emit(dict(phase="kernel_c_vs_plain", shapes_hw=shapes, batch=BATCH, staged_batch=1,
              bit_equal_to_plain=True, bit_equal_to_kernel_a=True,
              max_abs_err=c_err, bytes_ms=c_times[0], ops_ms=c_times[1]))

    # The initial image's blur: the doubled grayscale frames, pre-blur sigma
    # sqrt(1.6^2 - 1) (models/pyramid.compute_initial_image).
    gray = upsample_bilinear(to_grayscale(imgs).to(cfg.dtype), 2, 2).contiguous()
    pre = gaussian_half_kernel(math.sqrt(cfg.init_sigma * cfg.init_sigma - 1))
    initial = separable_blur_kernel(gray, pre)
    d_err = max(d_err, same(initial, separable_blur(gray, pre), "kernel D initial vs plain"))
    same(initial, seeds[0], "kernel D initial vs the main path's seed")
    for i in range(2):  # the staged path's per-frame initial image
        one = gray[i: i + 1].contiguous()
        d_err = max(d_err, same(separable_blur_kernel(one, pre), separable_blur(one, pre),
                                f"kernel D frame {i} initial vs plain"))
    d_times = blur_bound(tuple(gray.shape), pre)
    emit(dict(phase="kernel_d_vs_plain", initial_shape=list(gray.shape),
              initial_taps=len(pre), initial_plan=d_plan(tuple(gray.shape), pre),
              one_frame_plan=d_plan((1,) + tuple(gray.shape[1:]), pre),
              chain_blurs=d_checked, bit_equal=True,
              max_abs_err=d_err, bytes_ms=d_times[0], ops_ms=d_times[1]))

    # -- kernel E vs its plain version: the batch's gauss and DoG stacks at
    # the non-front route's twin width and at 128, through the launcher into
    # NaN-filled buffers (a row the launch misses stays NaN), and through the
    # wrapper (one launch a space) ----------------------------------------------
    e_err = 0.0
    e_rows, e_in = [], 0
    for name, stacks in (("gauss", gs16), ("dog", ds16)):
        for blk in (S.TWIN_BLK, 128):
            e_err = max(e_err, check_twin_launch(stacks, blk, f"kernel E {name}"))
        before = kernels.launch_counts()["twin_rows"]
        got = twin_rows_strips(stacks, S.TWIN_BLK)
        ref = twin_rows_strips_plain(stacks, S.TWIN_BLK)
        torch.cuda.synchronize()
        need(kernels.launch_counts()["twin_rows"] == before + 1,
             f"kernel E {name}: not one launch")
        need((got.nbs, got.bases, got.shp) == (ref.nbs, ref.bases, ref.shp), f"kernel E {name} plan")
        e_err = max(e_err, same(got.rows, ref.rows, f"kernel E {name} wrapper vs plain"))
        e_rows.append(got.rows.numel())
        e_in += sum(v.numel() for v in stacks)
        del got, ref
    e_times = twin_bound(e_in, sum(e_rows))
    emit(dict(phase="kernel_e_vs_plain", stacks=["gauss", "dog"], batch=BATCH,
              blks=[S.TWIN_BLK, 128], nan_filled_buffers=True, launches_per_space=1,
              buffer_floats=e_rows, bit_equal=True, max_abs_err=e_err,
              bytes_ms=e_times[0], ops_ms=e_times[1]))

    # -- kernel F vs its plain version at every octave shape of the batch, in
    # the front-twin route's own layout; what it wrote read back through the
    # gather spaces' index against kernel A's stacks ---------------------------
    plan = S.front_twin_plan(cfg, octaves, *shapes[0])
    need([(o[0], o[1]) for o in plan.octaves] == shapes and all(o[3] for o in plan.octaves),
         f"front-twin plan {plan.octaves}")
    f_args = [(seed, hks, thr, gbase, st, plan.blk, plan.g_l0, plan.g_nl, pkbase)
              for seed, (_, _, st, _, _, gbase), pkbase in zip(seeds, plan.octaves, plan.pk_bases)]

    def twin_buffers():
        return (torch.zeros((BATCH, plan.g_total, 2 * plan.blk), device=dev),
                torch.zeros((BATCH, plan.pk_total, 128), device=dev))

    def run_f(fn, gbuf, pkbuf, args=None):
        return [fn(sd, hk, t, gbuf, gb, st, blk, l0, nl, pkbuf, pb)
                for sd, hk, t, gb, st, blk, l0, nl, pb in args or f_args]

    gk, pkk = twin_buffers()
    gp, pkp = twin_buffers()
    f_err = 0.0
    for o, (got, ref) in enumerate(zip(run_f(octave_front_twin, gk, pkk),
                                       run_f(octave_front_twin_plain, gp, pkp))):
        for name, a, b in zip(("mask", "counts", "down"), got, ref):
            f_err = max(f_err, same(a, b, f"kernel F octave {o} {name} vs plain"))
    torch.cuda.synchronize()
    f_err = max(f_err, same(gk, gp, "kernel F gauss twin rows vs plain"),
                same(pkk, pkp, "kernel F cube-packed rows vs plain"))
    del gp, pkp
    # The same at the 4-interval chain: 6 blurs, 4 stored gauss layers,
    # 21-lane packed windows, the smaller row batch.
    plan4 = S.front_twin_plan(cfg4, octaves, *shapes[0])
    f4_args = [(seed, hks4, thr, gbase, st, plan4.blk, plan4.g_l0, plan4.g_nl, pkbase)
               for seed, (_, _, st, _, _, gbase), pkbase
               in zip(seeds, plan4.octaves, plan4.pk_bases)]
    bufs4 = [(torch.zeros((BATCH, plan4.g_total, 2 * plan4.blk), device=dev),
              torch.zeros((BATCH, plan4.pk_total, 128), device=dev)) for _ in range(2)]
    for o, (got, ref) in enumerate(zip(run_f(octave_front_twin, *bufs4[0], f4_args),
                                       run_f(octave_front_twin_plain, *bufs4[1], f4_args))):
        for name, a, b in zip(("mask", "counts", "down"), got, ref):
            same(a, b, f"kernel F octave {o} {name}, 4-interval chain, vs plain")
    same(bufs4[0][0], bufs4[1][0], "kernel F gauss twin rows, 4-interval chain, vs plain")
    same(bufs4[0][1], bufs4[1][1], "kernel F cube-packed rows, 4-interval chain, vs plain")
    del bufs4, got, ref
    gmr, dcr, f_masks, f_counts = front_twin_pyramids(seeds[0], cfg, plan)
    same(gmr.rows, gk, "front_twin_pyramids gauss rows vs kernel F alone")
    same(dcr.rows, pkk, "front_twin_pyramids packed rows vs kernel F alone")
    need(gmr.rows_u.shape == (BATCH, plan.g_total // plan.unit, plan.unit * 2 * plan.blk)
         and gmr.rows_u.data_ptr() == gmr.rows.data_ptr(), "rows_u is not a view of the rows")
    img_i = torch.arange(BATCH, device=dev)[:, None, None, None]
    a_dogs = []
    for o, seed in enumerate(seeds):
        ga, da, ma, ca = octave_front(seed, hks, thr)
        same(f_masks[o], ma, f"kernel F octave {o} mask vs kernel A")
        same(f_counts[o], ca, f"kernel F octave {o} counts vs kernel A")
        h, w = shapes[o]
        oc = torch.full((1, 1, 1, 1), o, device=dev)
        yy = torch.arange(h, device=dev)[None, None, :, None]
        xx = torch.arange(w, device=dev)[None, None, None, :]
        ll = torch.arange(plan.g_l0, plan.g_l0 + plan.g_nl, device=dev)[None, :, None, None]
        for x0 in (xx, (xx - plan.blk).clamp_min(0)):  # a value's own twin block, and the one before
            same(gmr.flat[gmr.index(img_i, oc, ll, yy, xx, x0)],
                 ga[:, plan.g_l0: plan.g_l0 + plan.g_nl], f"octave {o} gauss through MultiRows.index")
        ll = torch.arange(len(hks), device=dev)[None, :, None, None]
        for back in (0, 1, 2):  # the window starts a cube gather reads column x from
            same(dcr.flat[dcr.index(img_i, oc, ll, yy, xx, (xx - back).clamp_min(0))], da,
                 f"octave {o} DoG through CubeRows.index")
        a_dogs.append(da)
        del ga, ma, ca
    f_times = front_twin_bound(plan, BATCH, hks)
    emit(dict(phase="kernel_f_vs_plain", shapes_hw=shapes, batch=BATCH,
              strips=[o[2] for o in plan.octaves], unit=plan.unit,
              gauss_rows_per_image=plan.g_total, packed_rows_per_image=plan.pk_total,
              bit_equal_to_plain=True, index_reads_equal_kernel_a=True, max_abs_err=f_err,
              bit_equal_at_4_intervals=True,
              bytes_ms=f_times[0], ops_ms=f_times[1]))
    del gmr, f_masks, f_counts

    # -- kernel G vs its plain version on the batch's eight DoG stacks at the
    # plan's strips, and against what kernel F wrote for the same octaves ------
    g_err = 0.0
    g_in = g_out = 0
    g_args = [(d, o[2], pb) for d, o, pb in zip(a_dogs, plan.octaves, plan.pk_bases)]
    pkg = torch.zeros_like(pkk)
    for o, (d, st, pb) in enumerate(g_args):
        alone = cube_pack_rows(d, st)
        g_err = max(g_err, same(alone, cube_rows_plain(d, st), f"kernel G octave {o} vs plain"))
        cube_pack_rows(d, st, out=pkg, base=pb)
        same(pkg[:, pb: pb + alone.shape[1]], alone, f"kernel G octave {o} in place vs alone")
        g_in += d.numel()
        g_out += alone.numel()
        del alone
    torch.cuda.synchronize()
    g_err = max(g_err, same(pkg, pkk, "kernel G's buffer vs kernel F's"),
                check_cube_launch(a_dogs, [a[1] for a in g_args], plan.pk_bases, plan.pk_total,
                                  "kernel G batch"))
    g_times = twin_bound(g_in, g_out)
    emit(dict(phase="kernel_g_vs_plain", batch=BATCH, strips=[a[1] for a in g_args],
              floats_in=g_in, floats_out=g_out, bit_equal_to_plain=True,
              bit_equal_to_kernel_f=True, nan_filled_buffer=True, max_abs_err=g_err,
              bytes_ms=g_times[0], ops_ms=g_times[1]))
    del dcr

    # -- kernel H vs its plain version: one frame's gauss and DoG stacks, the
    # staged path's blk 128 and the batch routes' 64, through the launcher
    # into NaN-filled buffers and through build_multi_rows (one launch) and
    # twin_rows_2d (single volumes) -----------------------------------------
    h_vols = [g[0] for g in gs16] + [d[0] for d in ds16]
    h_err = 0.0
    h_in = sum(v.numel() for v in h_vols)
    for blk in (128, 64):
        h_err = max(h_err, check_rows_launch(h_vols, blk, "kernel H"))
        before = kernels.launch_counts()["twin_rows_2d"]
        got = build_multi_rows(h_vols, blk)
        need(kernels.launch_counts()["twin_rows_2d"] == before + 1,
             "build_multi_rows: not one launch of kernel H")
        ref = torch.cat([twin_rows_2d_plain(v.reshape(-1, v.shape[-1]), blk) for v in h_vols])
        h_err = max(h_err, same(got.rows, ref, f"kernel H blk {blk} build_multi_rows vs plain"))
        for v in h_vols[::5]:
            m = v.reshape(-1, v.shape[-1])
            h_err = max(h_err, same(twin_rows_2d(m, blk), twin_rows_2d_plain(m, blk),
                                    f"kernel H blk {blk} single {tuple(m.shape)} vs plain"))
        if blk == 128:
            h_out = got.rows.numel()
        del got, ref
    h_times = twin_bound(h_in, h_out)
    emit(dict(phase="kernel_h_vs_plain", volumes=len(h_vols), blks=[128, 64], floats_in=h_in,
              nan_filled_buffers=True, launches_per_build_multi_rows=1,
              floats_out_blk128=h_out, bit_equal=True, max_abs_err=h_err,
              bytes_ms=h_times[0], ops_ms=h_times[1]))

    # -- phase 4: kernel B vs its plain version, 8 pairs at 2048 x 2048 (the
    # main path's) and one pair at the demo's 1286 x 1430, ties planted ------
    pairs, n = BATCH // 2, cfg.ori_cap
    b_err = 0
    b_in = {}
    for what, shape in (("main", (pairs, n, n)), ("pair", (1,) + DEMO_KP)):
        d1, d2, v2 = (t.to(dev) for t in planted_top2(*shape))
        got = top2(d1, d2, v2)
        ref = top2_plain(d1, d2, v2)
        torch.cuda.synchronize()
        for name, a, b in zip(("best", "second", "idx"), got, ref):
            b_err = max(b_err, (a.long() - b.long()).abs().max().item())
            need(torch.equal(a, b), f"kernel B {what} {name} differs from the plain version")
        b_in[what] = (d1, d2, v2)
    b_times = top2_bound(pairs, n, n)
    emit(dict(phase="kernel_b_vs_plain", shapes=dict(main=[pairs, n, n], pair=[1, *DEMO_KP]),
              splits=dict(main=top2_split_for(pairs, n, n), pair=top2_split_for(1, *DEMO_KP)),
              ties_planted=True, equal=True, bytes_ms=b_times[0], ops_ms=b_times[1]))
    # ``ms`` is CUDA events around host launches, as for every kernel; B's
    # launch is shorter than its wrapper's host time, so its device time, the
    # launches replayed from a CUDA graph, stands beside it as ``device_ms``.
    b_ms = cuda_ms(lambda: top2(*b_in["main"]), KERNEL_REPS)
    b_dev_ms = graph_ms(lambda: top2(*b_in["main"]), KERNEL_REPS)
    b_pair_ms = cuda_ms(lambda: top2(*b_in["pair"]), KERNEL_REPS)
    b_pair_dev_ms = graph_ms(lambda: top2(*b_in["pair"]), KERNEL_REPS)
    b_plain_ms = cuda_ms(lambda: top2_plain(*b_in["main"]), 5)
    f1, f2 = (t.float() for t in b_in["main"][:2])
    b_lib_ms = cuda_ms(lambda: torch.cdist(f1, f2).topk(2, dim=-1, largest=False), 5)
    b_bound, b_by = bound(*b_times)
    b_pair_bound = bound(*top2_bound(1, *DEMO_KP))[0]
    del b_in, f1, f2

    # Reference match set: the oracle's own descriptors through the plain matcher.
    od1 = torch.from_numpy(o1["final.desc"])[None]
    od2 = torch.from_numpy(o2["final.desc"])[None]
    rb, rs, ri = top2_plain(od1, od2, torch.ones(od2.shape[:2], dtype=torch.bool))
    racc = ratio_accept(rb, rs, torch.ones(od1.shape[:2], dtype=torch.bool))[0]
    want = {(i, int(ri[0, i])) for i in np.nonzero(racc.numpy())[0]}
    need(len(want) == WANT_MATCHES, f"oracle match set has {len(want)}")
    oracle_set = want  # for the parallel phase (``want`` is a loop name later)

    def check_matches(desc1, valid1, desc2, valid2, what):
        """Every pair's ratio-test matches (kernel B) are the oracle's set."""
        idx, acc, _, _ = match_descriptors(desc1, valid1, desc2, valid2,
                                           cfg.ratio_threshold, device=dev)
        acc_c, idx_c = acc.cpu().numpy(), idx.cpu().numpy()
        for p in range(acc_c.shape[0]):
            got_set = {(i, int(idx_c[p, i])) for i in np.nonzero(acc_c[p])[0]}
            need(got_set == want, f"{what} pair {p}: {len(got_set)} matches, "
                 f"{len(got_set ^ want)} differ from the oracle's 165-match set")

    def honest(kp, counts, what, c=cfg):
        """No capacity of ``c`` clipped a real detection and every value is
        finite."""
        bad = S.clipped(counts, c)
        need(not bad, f"{what}: clipped {bad}")
        for k, v in kp.to_numpy().items():
            if v.dtype.kind == "f":
                need(np.isfinite(v).all(), f"{what}: non-finite {k}")

    def check_batch(kp, counts, what):
        nkp = kp.valid.sum(1).tolist()
        need(nkp == list(WANT_KP) * (BATCH // 2), f"{what}: keypoint counts {nkp}")
        honest(kp, counts, what)
        check_matches(kp.desc[0::2], kp.valid[0::2], kp.desc[1::2], kp.valid[1::2], what)
        return nkp

    def same_buffers(a, b, what):
        for f in FIELDS:
            same(getattr(a, f), getattr(b, f), f"{what}: {f}")

    def expect_launches(path, want):
        got = {k: launches[path][k] for k in want}
        need(got == want, f"{path}: launches {launches[path]}, want {want}")

    # -- phase 5: the main path (the front-twin route through the entry
    # point), counted ----------------------------------------------------------
    need(S.route_of(cfg, dev) == "front_twin", "the entry point does not take the front-twin route")
    zero_counts()
    kp, counts = S.detect_and_describe_batch(imgs, cfg, return_counts=True, device=dev)
    main_kp = kp  # the parallel phase's reference (``kp`` is a loop name later)
    match_descriptors(kp.desc[0::2], kp.valid[0::2], kp.desc[1::2], kp.valid[1::2],
                      cfg.ratio_threshold, device=dev)
    launches = {"main": read_counts()}
    expect_launches("main", dict(octave_front_twin=octaves, octave_front=0, cube_pack=0,
                                 blur_pass=1, top2=1, octave_blur=0, twin_rows=0, twin_rows_2d=0,
                                 describe=1, detect=1, orient=1))
    nkp = check_batch(kp, counts, "main path")

    # The plain-stack front route, counted.
    zero_counts()
    kf, cf = S.run_route(imgs, cfg, "front")
    match_descriptors(kf.desc[0::2], kf.valid[0::2], kf.desc[1::2], kf.valid[1::2],
                      cfg.ratio_threshold, device=dev)
    launches["front"] = read_counts()
    expect_launches("front", dict(octave_front=octaves, octave_front_twin=0, cube_pack=0,
                                  blur_pass=1, top2=1, detect=1, orient=1))
    check_batch(kf, cf, "front route")
    same_buffers(kp, kf, "front-twin route vs front route")
    for k in counts:
        same(torch.as_tensor(counts[k]), torch.as_tensor(cf[k]), f"front-twin vs front count {k}")
    emit(dict(phase="front_twin_path", keypoints=nkp[:2], matches=WANT_MATCHES,
              same_match_set=True, equal_to_front_route=True, launches=launches["main"],
              counts={k: v.tolist() for k, v in counts.items()}))
    emit(dict(phase="path", route="front", keypoints=kf.valid.sum(1).tolist()[:2],
              matches=WANT_MATCHES, same_match_set=True, launches=launches["front"]))
    del kf, cf

    # The front-twin route with octaves 0 and 3 sent through its fallback.
    off = {shapes[0], shapes[3]}
    fb_plan = S.front_twin_plan(
        cfg, octaves, *shapes[0],
        strip_fn=lambda shape, *a: None if tuple(shape) in off else front_twin_strip(shape, *a))
    need([o[3] for o in fb_plan.octaves] == [tuple(sh) not in off for sh in shapes],
         f"fallback plan {fb_plan.octaves}")
    zero_counts()
    kb, cb = S.run_route(imgs, cfg, "front_twin", fb_plan)
    launches["fallback"] = read_counts()
    expect_launches("fallback", dict(octave_front=2, cube_pack=2, octave_front_twin=octaves - 2,
                                     blur_pass=1, detect=1, orient=1))
    check_batch(kb, cb, "front-twin fallback")
    same_buffers(kb, kp, "front-twin route with fallback octaves vs all fused")
    emit(dict(phase="front_twin_fallback", fallback_octaves=[0, 3],
              strips=[o[2] for o in fb_plan.octaves], keypoints=kb.valid.sum(1).tolist()[:2],
              equal_to_main_path=True, launches=launches["fallback"]))
    del kb, cb

    # -- phase 5b: wide frames through the entry point, octave 0 through the
    # fallback on its own (kernels A and G), counted ---------------------------
    launches["wide"], g_wide, wide_err = wide_fallback_phase(dev, wide_frames(), zero_counts,
                                                             read_counts, honest)

    # -- phase 6: the staged path, frame by frame, counted -------------------
    def staged_overflow(st, c):
        cnt, out = st["counts"], []
        for o in range(len(st["gaussians"])):
            for k, cap in (("extrema", c.extrema_cap_for_octave(o)),
                           ("refined", c.kp_cap_for_octave(o)),
                           ("oriented", 2 * c.kp_cap_for_octave(o))):
                if int(cnt[k][o]) > cap:
                    out.append(f"{k}[{o}] {int(cnt[k][o])} > {cap}")
        if int(cnt["ori_slots_max"].max()) > c.ori_cand_slots:
            out.append(f"ori_slots_max {int(cnt['ori_slots_max'].max())} > {c.ori_cand_slots}")
        if int(cnt["final"]) > c.ori_cap:
            out.append(f"final {int(cnt['final'])} > {c.ori_cap}")
        return out

    def run_staged(frames, c, octs, path):
        """detect_stages on each frame, counted as ``path``; the per-octave
        capacities doubled (at most three times) until none clips.
        Returns (stage dicts, the configuration that ran, what was raised)."""
        raised = []
        while True:
            zero_counts()
            staged = [S.detect_stages(f, c, octs, device=dev) for f in frames]
            launches[path] = read_counts()
            over = [x for st in staged for x in staged_overflow(st, c)]
            if not over:
                return staged, c, raised
            need(len(raised) < 3, f"{path}: capacities still clipped: {over}")
            c = dataclasses.replace(
                c, extrema_cap=2 * c.extrema_cap, kp_cap=2 * c.kp_cap,
                ori_cap=2 * c.ori_cap, ori_cand_slots=2 * c.ori_cand_slots)
            raised.append(dict(overflow=over, raised_to=dict(
                extrema_cap=c.extrema_cap, kp_cap=c.kp_cap, ori_cap=c.ori_cap,
                ori_cand_slots=c.ori_cand_slots)))

    staged, scfg, raised = run_staged([o1["input"], o2["input"]], cfg, octaves, "staged")
    # Per frame and octave kernel H builds the DoG rows (refine) and the gauss
    # rows twice (orientation, descriptors), as the JAX package's stages do.
    expect_launches("staged", dict(octave_blur=octaves * 2, blur_pass=2,
                                   twin_rows_2d=3 * octaves * 2, octave_front=0,
                                   octave_front_twin=0, describe=octaves * 2, detect=0,
                                   orient=octaves * 2))
    for i, st in enumerate(staged):
        fin = st["final"]
        need(int(fin.valid.sum()) == WANT_KP[i], f"staged frame {i}: {int(fin.valid.sum())} kp")
        for f in ("x", "y", "size", "pori", "octave", "layer", "desc"):
            same(getattr(fin, f)[fin.valid], getattr(kp, f)[i][kp.valid[i]],
                 f"staged frame {i} {f} vs the main path")
    fa, fb = staged[0]["final"], staged[1]["final"]
    check_matches(fa.desc[None], fa.valid[None], fb.desc[None], fb.valid[None], "staged")
    emit(dict(phase="staged_path", frames=2, octaves=octaves,
              keypoints=[int(st["final"].valid.sum()) for st in staged],
              matches=WANT_MATCHES, same_match_set=True, equal_to_main_path=True,
              launches=launches["staged"], capacities_raised=raised,
              counts=[{k: v.tolist() for k, v in st["counts"].items()} for st in staged]))
    del staged

    # -- phase 7: the non-front (XLA) route, batch 16, counted ---------------
    xcfg = dataclasses.replace(cfg, use_octave_kernel=False)
    need(S.route_of(xcfg, dev) == "twin_rows", "use_octave_kernel=False: not the twin-row route")
    zero_counts()
    kx, cx = S.detect_and_describe_batch(imgs, xcfg, return_counts=True, device=dev)
    launches["xla_route"] = read_counts()
    n_blurs = 1 + len(hks) * octaves
    expect_launches("xla_route", dict(octave_front=0, top2=0, octave_blur=0,
                                      blur_pass=n_blurs, twin_rows=2,
                                      octave_front_twin=0, cube_pack=0, twin_rows_2d=0,
                                      describe=1, detect=0, orient=1))
    check_batch(kx, cx, "XLA route")
    same_buffers(kx, kp, "XLA route vs the main path")
    emit(dict(phase="xla_route", keypoints=kx.valid.sum(1).tolist()[:2],
              matches=WANT_MATCHES, same_match_set=True, equal_to_main_path=True,
              launches=launches["xla_route"],
              counts={k: v.tolist() for k, v in cx.items()}))
    del kx, cx

    # -- phase 8: the non-front route as window_size=5 takes it, batch 16,
    # counted: kernels D (initial image), C, E and B ---------------------------
    wcfg = dataclasses.replace(cfg, window_size=5)
    need(S.route_of(wcfg, dev) == "twin_rows", "window_size=5: not the twin-row route")
    zero_counts()
    kw, cw = S.detect_and_describe_batch(imgs, wcfg, return_counts=True, device=dev)
    _, accw, _, _ = match_descriptors(kw.desc[0::2], kw.valid[0::2], kw.desc[1::2],
                                      kw.valid[1::2], cfg.ratio_threshold, device=dev)
    launches["window5"] = read_counts()
    expect_launches("window5", dict(octave_front=0, octave_front_twin=0, octave_blur=octaves,
                                    blur_pass=1, twin_rows=2, top2=1, detect=0, orient=1))
    honest(kw, cw, "window-5 route")
    nkw = kw.valid.sum(1).tolist()
    need(min(nkw) > 0, f"window-5 route: keypoint counts {nkw}")
    plain_layout, _ = S.run_route(imgs, wcfg, "stacks")
    for f in FIELDS:
        same(getattr(kw, f), getattr(plain_layout, f), f"window-5 route {f} vs plain stacks")
        same(getattr(kw, f)[2:], getattr(kw, f)[:-2], f"window-5 route {f} across equal frames")
    emit(dict(phase="window5_route", keypoints=nkw[:2], matches=int(accw[0].sum()),
              equal_to_plain_stacks=True, equal_frames_equal=True,
              launches=launches["window5"], counts={k: v.tolist() for k, v in cw.items()}))
    del kw, cw, plain_layout

    # -- phase 8b: the demo pair (755 x 499, doubled to 1510 x 998: neither
    # even nor a multiple of 64), batch 2, float32, through the main path, the
    # fallback (octaves 0 and 3), the front route, the XLA route and the staged
    # path, each counted; kernels D and B against their plain versions at the
    # demo's shapes ---------------------------------------------------------
    dcfg = SiftConfig(**DEMO_CAPS)
    od = [np.load(DATA / f"oracle_demo{i}.npz") for i in (1, 2)]
    dimgs = S.as_batch(np.stack([o["input"] for o in od]), dcfg, dev)
    doct = S.octaves_for(dimgs, dcfg)
    dgray = upsample_bilinear(to_grayscale(dimgs).to(dcfg.dtype), 2, 2).contiguous()
    dseed = separable_blur_kernel(dgray, pre)
    d_err = max(d_err, same(dseed, separable_blur(dgray, pre), "kernel D demo initial vs plain"))
    d_plan(tuple(dgray.shape), pre)
    dshapes, dgs, dds = [], [], []
    for o in range(doct):
        dshapes.append(tuple(dseed.shape[1:]))
        g_plain, dog_plain = octave_blur_plain(dseed, hks)
        for k, hk in enumerate(hks):
            layer = g_plain[:, k].contiguous()
            d_err = max(d_err, same(separable_blur_kernel(layer, hk), separable_blur(layer, hk),
                                    f"kernel D demo octave {o} blur {k + 1} vs plain"))
            d_plan(tuple(layer.shape), hk)
        dseed = downsample_nearest_x2(g_plain[:, g_plain.shape[1] - 3]).contiguous()
        dgs.append(g_plain)
        dds.append(dog_plain.contiguous())
        del g_plain, dog_plain
    # Kernels E and H at the demo's shapes (widths 1510, 755, ..., 11), the
    # batch's stacks and one frame's volumes, into NaN-filled buffers.
    for blk in (S.TWIN_BLK, 128):
        for name, stacks in (("gauss", dgs), ("dog", dds)):
            e_err = max(e_err, check_twin_launch(stacks, blk, f"kernel E demo {name}"))
        h_err = max(h_err, check_rows_launch([v[0] for v in dgs + dds], blk, "kernel H demo"))
    # Kernel G at the demo's DoG stacks (odd widths: its 4-byte staging), at
    # the plan's strips and bases.
    dplan = S.front_twin_plan(dcfg, doct, *dshapes[0])
    g_err = max(g_err, check_cube_launch(dds, [o[2] for o in dplan.octaves], dplan.pk_bases,
                                         dplan.pk_total, "kernel G demo"))
    del dgs, dds

    def demo_match(kp):
        return match_descriptors(kp.desc[0:1], kp.valid[0:1], kp.desc[1:2], kp.valid[1:2],
                                 dcfg.ratio_threshold, device=dev)

    zero_counts()
    dk, dc = S.detect_and_describe_batch(dimgs, dcfg, return_counts=True, device=dev)
    didx, dacc, _, _ = demo_match(dk)
    launches["demo_main"] = read_counts()
    expect_launches("demo_main", dict(octave_front_twin=doct, octave_front=0, cube_pack=0,
                                      blur_pass=1, top2=1, octave_blur=0, twin_rows=0,
                                      twin_rows_2d=0, detect=1, orient=1))
    honest(dk, dc, "demo main path", dcfg)
    for name, a, b in zip(("best", "second", "idx"),
                          top2(dk.desc[0:1], dk.desc[1:2], dk.valid[1:2]),
                          top2_plain(dk.desc[0:1], dk.desc[1:2], dk.valid[1:2])):
        same(a, b, f"kernel B demo descriptors {name} vs plain")
    dkp = dk.valid.sum(1).tolist()
    dmatches = int(dacc.sum())
    rb, rs, ri = top2_plain(*(torch.from_numpy(o["final.desc"])[None] for o in od),
                            torch.ones((1, DEMO_KP[1]), dtype=torch.bool))
    racc = ratio_accept(rb, rs, torch.ones((1, DEMO_KP[0]), dtype=torch.bool))[0]
    need(int(racc.sum()) == DEMO_MATCHES, f"demo oracle match set has {int(racc.sum())}")
    need([(o[0], o[1]) for o in dplan.octaves] == dshapes and all(o[3] for o in dplan.octaves),
         f"demo front-twin plan {dplan.octaves}")
    doff = {dshapes[0], dshapes[3]}
    dfb_plan = S.front_twin_plan(
        dcfg, doct, *dshapes[0],
        strip_fn=lambda shape, *a: None if tuple(shape) in doff else front_twin_strip(shape, *a))
    dx_cfg = dataclasses.replace(dcfg, use_octave_kernel=False)
    routes = {}
    for path, run, want in (
            ("demo_fallback", lambda: S.run_route(dimgs, dcfg, "front_twin", dfb_plan),
             dict(octave_front=2, cube_pack=2, octave_front_twin=doct - 2, blur_pass=1,
                  detect=1, orient=1)),
            ("demo_front", lambda: S.run_route(dimgs, dcfg, "front"),
             dict(octave_front=doct, octave_front_twin=0, cube_pack=0, blur_pass=1, detect=1,
                  orient=1)),
            ("demo_xla_route", lambda: S.detect_and_describe_batch(
                dimgs, dx_cfg, return_counts=True, device=dev),
             dict(octave_front=0, octave_front_twin=0, octave_blur=0,
                  blur_pass=1 + len(hks) * doct, twin_rows=2, detect=0, orient=1))):
        zero_counts()
        kr, cr = run()
        launches[path] = read_counts()
        expect_launches(path, want)
        honest(kr, cr, path, dcfg)
        same_buffers(kr, dk, f"{path} vs the demo main path")
        routes[path] = kr.valid.sum(1).tolist()
        del kr, cr
    dstaged, dscfg, draised = run_staged([o["input"] for o in od], dcfg, doct, "demo_staged")
    expect_launches("demo_staged", dict(octave_blur=doct * 2, blur_pass=2,
                                        twin_rows_2d=3 * doct * 2, octave_front=0,
                                        octave_front_twin=0, detect=0, orient=doct * 2))
    for i, st in enumerate(dstaged):
        fin = st["final"]
        for f in ("x", "y", "size", "pori", "octave", "layer", "desc"):
            same(getattr(fin, f)[fin.valid], getattr(dk, f)[i][dk.valid[i]],
                 f"demo staged frame {i} {f} vs the main path")
    routes["demo_staged"] = [int(st["final"].valid.sum()) for st in dstaged]
    dmine = {(i, int(j)) for i, j in enumerate(didx[0].tolist()) if bool(dacc[0, i])}
    dwant = {(i, int(ri[0, i])) for i in np.nonzero(racc.numpy())[0]}

    def unmatched(a, b):
        """(x, y, size) rows of ``a`` with no row of ``b`` within 0.01 in each."""
        if not len(b):
            return a.round(3).tolist()
        return a[np.abs(a[:, None] - b[None]).max(-1).min(1) > 0.01].round(3).tolist()

    off_anchor = {}
    for i, o in enumerate(od):
        v = dk.valid[i]
        mine_xys = np.stack([getattr(dk, f)[i][v].double().cpu().numpy() for f in ("x", "y", "size")], 1)
        want_xys = np.stack([o[f"final.{f}"] for f in ("x", "y", "size")], 1)
        off_anchor[f"demo{i + 1}"] = dict(missing=unmatched(want_xys, mine_xys),
                                          extra=unmatched(mine_xys, want_xys))
    emit(dict(phase="demo_pair", frames_hw=list(dimgs.shape[1:3]), doubled_hw=list(dshapes[0]),
              octave_shapes_hw=dshapes, batch=2, caps=DEMO_CAPS, strips=[o[2] for o in dplan.octaves],
              keypoints=dkp, matches=dmatches, routes_keypoints=routes,
              every_route_equal_to_main_path=True, launches={k: launches[k] for k in (
                  "demo_main", "demo_fallback", "demo_front", "demo_xla_route", "demo_staged")},
              anchor_exact=dkp == list(DEMO_KP) and dmatches == DEMO_MATCHES,
              keypoints_minus_anchor=[a - b for a, b in zip(dkp, DEMO_KP)],
              matches_minus_anchor=dmatches - DEMO_MATCHES,
              keypoints_off_anchor=off_anchor,
              # Index pairs line up with the oracle's only where the counts do.
              same_match_set_as_oracle=dmine == dwant if dkp == list(DEMO_KP) else None,
              staged_capacities_raised=draised,
              counts={k: v.tolist() for k, v in dc.items()}))
    del dk, dc, dstaged

    # -- phase 8c: the pair CLI on the CAVE 00 / 01 frames written as PNG:
    # ``cli.main`` in this process, counted, then ``python -m sift_tpu_torch``
    # as a user runs it -------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pngs = [str(tmp / f"cave0{i}.png") for i in (0, 1)]
        for path, o in zip(pngs, (o1, o2)):
            save_image(path, o["input"])
        printed = io.StringIO()
        zero_counts()
        with contextlib.redirect_stdout(printed):
            rc = cli.main([*pngs, "--json", "--out-dir", str(tmp / "in_process")])
        launches["cli"] = read_counts()
        need(rc == 0, f"cli.main exited {rc}")
        expect_launches("cli", dict(octave_front_twin=octaves, blur_pass=1, top2=1,
                                    octave_front=0, cube_pack=0, octave_blur=0, twin_rows=0,
                                    twin_rows_2d=0, detect=1, orient=1))
        in_process = json.loads(printed.getvalue().strip().splitlines()[-1])
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "sift_tpu_torch", *pngs, "--json",
                               "--out-dir", str(tmp / "out")],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_wall_s = time.perf_counter() - t
        need(proc.returncode == 0,
             f"python -m sift_tpu_torch exited {proc.returncode}: {proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        for what, got in (("cli.main", in_process), ("python -m sift_tpu_torch", summary)):
            need((got["keypoints1"], got["keypoints2"], got["matches"])
                 == (*WANT_KP, WANT_MATCHES), f"{what}: {got}")
        for d in ("in_process", "out"):
            for name in ("keypoints1.png", "keypoints2.png", "matches.png"):
                need((tmp / d / name).is_file(), f"the CLI wrote no {d}/{name}")
    emit(dict(phase="cli", command="python -m sift_tpu_torch cave00.png cave01.png --json",
              summary=summary, in_process_summary=in_process, subprocess_wall_s=cli_wall_s,
              native_decoder=native.available(), pngs_written=True, launches=launches["cli"]))

    # -- phase 8d: stitching on the CAVE-01 scene (35 frames, 640x480, no
    # graph file: the chain graph centred at 17), default capacities: the
    # ``stitch`` command in this process (counted) and as a subprocess, the
    # scene at library level, the card against the CPU on frames 00-04, and
    # the cylindrical driver --------------------------------------------------
    blends = {"multiband": 0, "feather": 0}

    def counted_blend(mod, name, key):
        fn = getattr(mod, name)

        def run(*a, **k):
            blends[key] += 1
            return fn(*a, **k)
        setattr(mod, name, run)

    counted_blend(BL, "_multiband_scan", "multiband")
    counted_blend(ST, "_blend_strip", "feather")

    def blend_ran(before):
        got = [k for k in blends if blends[k] > before[k]]
        need(len(got) == 1, f"blends run: {blends} after {before}")
        return got[0]

    def host_s(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def pano_ok(pano, what, blend):
        """Finite and not negative; at most 255 where the multiband blend
        ran (it clips).  The feather fallback returns the gain-scaled
        average unclipped, as the JAX package's ``blend_warped`` does, so
        there the bound holds for the panorama as written (``save_image``
        clips).  Returns the share of non-black pixels."""
        bad = int((~np.isfinite(pano)).sum())
        need(bad == 0 and pano.min() >= 0, f"{what}: {bad} non-finite values, min {pano.min()}")
        need(blend == "feather" or pano.max() <= 255, f"{what}: max {pano.max()} after {blend}")
        return float((pano.max(-1) > 0).mean())

    scfg_default = SiftConfig()
    stcfg = SiftConfig(**SCENE_CAPS)
    frames35 = [np.load(DATA / "scene_oracle" / f"cave01_{i:02d}.npz") for i in range(SCENE_FRAMES)]
    graph = chain_graph(SCENE_FRAMES)
    mid = SCENE_FRAMES // 2
    tree = [(i, p) for i, p in graph.bfs_parents().items() if i != mid]
    need(graph.center_index == mid and sorted(tree) == sorted(
        [(i, i + 1) for i in range(mid)] + [(i, i - 1) for i in range(mid + 1, SCENE_FRAMES)]),
        f"chain graph {graph}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        sdir = tmp / "cave01"
        sdir.mkdir()
        for i, o in enumerate(frames35):
            save_image(str(sdir / f"{i:02d}.png"), o["input"])
        printed = io.StringIO()
        before = dict(blends)
        zero_counts()
        with contextlib.redirect_stdout(printed):
            rc, cli_stitch_s = host_s(lambda: cli.main(
                ["stitch", str(sdir), "--out", str(tmp / "pano_in_process.png")]))
        launches["stitch"] = read_counts()
        need(rc == 0, f"cli.main stitch exited {rc}")
        expect_launches("stitch", dict(octave_front_twin=SCENE_FRAMES * octaves,
                                       blur_pass=SCENE_FRAMES, top2=SCENE_FRAMES - 1,
                                       octave_front=0, cube_pack=0, octave_blur=0,
                                       twin_rows=0, twin_rows_2d=0, detect=SCENE_FRAMES,
                                       orient=SCENE_FRAMES))
        cli_blend = blend_ran(before)
        cli_line = printed.getvalue().strip().splitlines()[-1]
        cli_png = np.asarray(PILImage.open(tmp / "pano_in_process.png"))
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "sift_tpu_torch", "stitch", str(sdir),
                               "--out", str(tmp / "pano.png")],
                              cwd=ROOT, capture_output=True, text=True, timeout=900)
        stitch_wall_s = time.perf_counter() - t
        need(proc.returncode == 0,
             f"python -m sift_tpu_torch stitch exited {proc.returncode}: {proc.stderr[-2000:]}")
        need((tmp / "pano.png").is_file(), "python -m sift_tpu_torch stitch wrote no PNG")
        sub_line = proc.stdout.strip().splitlines()[-1]
        sub_warnings = [ln for ln in proc.stderr.splitlines() if "warning:" in ln]
        sub_png = np.asarray(PILImage.open(tmp / "pano.png"))

    # The scene at library level: detection frame by frame (``stitch_scene``'s
    # calls, with the true counts) at the command's default capacities
    # (what they clip is printed) and at capacities that cover every stage
    # (gated); on the latter, every chain edge's matches in the reference's
    # direction, each tree edge's RANSAC inliers, the edge solve and the
    # composite, timed.
    imgs35 = [o["input"].astype(np.float32) for o in frames35]

    def clipped(counts, c):
        """The capacities of ``c`` that a frame's true counts exceed."""
        return [f"{o['count']} {o['value']} > {o['cap']}" for o in S.clipped(counts, c)]

    def detect_all(c):
        out = []
        for img in imgs35:
            kp, n = S.detect_and_describe_batch(img[None], c, return_counts=True, device=dev)
            out.append((kp, n))
        return out

    detected, detect_s = host_s(lambda: detect_all(scfg_default))
    clipped_default = {f"{i:02d}": clipped(n, scfg_default) for i, (_, n) in enumerate(detected)}
    clipped_default = {k: v for k, v in clipped_default.items() if v}
    default_kp = [int(kp.valid.sum()) for kp, _ in detected]
    del detected
    warned = {ln.split(".png:")[0] for ln in sub_warnings}
    need(warned == set(clipped_default),
         f"the command warned for frames {sorted(warned)}, its capacities clip {clipped_default}")
    detected, detect_covering_s = host_s(lambda: detect_all(stcfg))
    for i, (kp, n) in enumerate(detected):
        honest(kp, n, f"scene frame {i:02d}", stcfg)
    kps35 = [kp.map(lambda a: a[0]) for kp, _ in detected]
    del detected
    scene_kp = [int(k.valid.sum()) for k in kps35]
    oracle_kp = [len(o["final.x"]) for o in frames35]
    need(scene_kp[:2] == list(WANT_KP), f"scene frames 00 / 01: {scene_kp[:2]} keypoints")
    chain_n, tree_inl = [], {}
    for i in range(SCENE_FRAMES - 1):
        chain_n.append(ST.match_points(kps35[i], kps35[i + 1], stcfg.ratio_threshold)[2].sum())
    for i, p in tree:
        p1, p2, ok = ST.match_points(kps35[i], kps35[p], stcfg.ratio_threshold)
        tree_inl[(i, p)] = ST.ransac_homography(p1, p2, ok, 2048)[2]
    chain_n = torch.stack(chain_n).tolist()
    tree_inl = dict(zip(tree_inl, torch.stack(list(tree_inl.values())).tolist()))
    need(chain_n[0] == WANT_MATCHES, f"scene edge 0-1: {chain_n[0]} matches")
    h_edge, edge_s = host_s(lambda: ST.solve_edge_homographies(kps35, graph, stcfg))
    # The same solve once more, counting the calls that wait for the device
    # (PyTorch's sync debug mode warns at each): the driver's one read of
    # all edge homographies, and whatever a library call adds.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ST.solve_edge_homographies(kps35, graph, stcfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync_kinds = {}
    for w in caught:
        if "synchronizing" in str(w.message):
            where = f"{Path(w.filename).name}:{w.lineno}"
            sync_kinds[where] = sync_kinds.get(where, 0) + 1
    hc = ST.chain_to_center(graph, h_edge)
    order = sorted(hc)
    c_h, c_w, c_t = ST._canvas_layout([imgs35[i] for i in order], [hc[i] for i in order])
    before = dict(blends)
    pano35, compose_s = host_s(lambda: ST.compose_scene(imgs35, graph, h_edge, device=dev))
    scene_blend = blend_ran(before)
    scene_cover = pano_ok(pano35, "35-frame scene", scene_blend)
    need(pano35.shape[:2] == cli_png.shape[:2] == sub_png.shape[:2],
         f"panorama shapes {pano35.shape} / {cli_png.shape} / {sub_png.shape}")
    lib_png = np.clip(pano35, 0, 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        _, png_write_s = host_s(lambda: save_image(str(Path(tmp) / "pano.png"), pano35))
    # The composite's first part alone (its low-resolution warps and the
    # host's pairwise overlap loop).
    _, gains_s = host_s(lambda: BL.estimate_gains(
        [imgs35[i] for i in order], [c_t @ hc[i] for i in order], c_h, c_w, device=dev))

    # The card against the CPU on frames 00-04 (the chain centred at 2), on
    # the card's keypoints copied to the CPU: the same hypotheses (the
    # sampler's CPU generator), corners and pixels compared.
    sub = chain_graph(5)
    kps5 = kps35[:5]
    kps5_cpu = [k.map(lambda a: a.cpu()) for k in kps5]
    for i, p in [(i, p) for i, p in sub.bfs_parents().items() if i != sub.center_index]:
        ok = ST.match_points(kps5[i], kps5[p], stcfg.ratio_threshold)[2]
        same(ST.sample_hypotheses(ok, 2048, 0).cpu(), ST.sample_hypotheses(ok.cpu(), 2048, 0),
             f"RANSAC samples of edge {i}-{p}, card vs CPU")
    h5_card = ST.solve_edge_homographies(kps5, sub, stcfg)
    h5_cpu = ST.solve_edge_homographies(kps5_cpu, sub, stcfg)
    before = dict(blends)
    pano5_card, compose5_s = host_s(lambda: ST.compose_scene(imgs35[:5], sub, h5_card, device=dev))
    blend5 = blend_ran(before)
    pano5_cpu = ST.compose_scene(imgs35[:5], sub, h5_cpu, device="cpu")
    need(blend_ran(before) == blend5, "the CPU run took another blend")
    corner_err = 0.0
    hc_card, hc_cpu = ST.chain_to_center(sub, h5_card), ST.chain_to_center(sub, h5_cpu)
    for i in range(5):
        cs = np.array([[0, 0, 1], [639, 0, 1], [0, 479, 1], [639, 479, 1]], np.float64)
        a, b = cs @ hc_card[i].T, cs @ hc_cpu[i].T
        corner_err = max(corner_err, float(np.abs(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:]).max()))
    need(corner_err <= 0.05, f"frames 00-04: corners card vs CPU {corner_err} px")
    need(pano5_card.shape == pano5_cpu.shape,
         f"frames 00-04: canvas {pano5_card.shape} vs {pano5_cpu.shape}")
    pano_ok(pano5_card, "frames 00-04 on the card", blend5)
    pano_ok(pano5_cpu, "frames 00-04 on the CPU", blend5)
    diff5 = np.abs(pano5_card - pano5_cpu).max(-1)
    within1 = float((diff5 <= 1.0).mean())
    need(within1 >= 0.995, f"frames 00-04: {within1} of pixels within 1 grey level")
    need("multiband" in (scene_blend, blend5), "no scene run reached multiband_blend")

    # A planted tie on the card: two hypotheses with 20 inliers each; the
    # first one wins (jnp.argmax's rule).
    rng = np.random.default_rng(6)
    pa, pb = rng.uniform(0, 400, (2, 20, 2))
    tie_p1 = torch.from_numpy(np.concatenate([pa, pb])).to(dev)
    tie_p2 = torch.from_numpy(np.concatenate([pa * 1.02 + 7.0, pb + [-40.0, 25.0]])).to(dev)
    tie_ok = torch.ones(40, dtype=torch.bool, device=dev)
    for rows, first in (([[0, 5, 11, 17], [20, 26, 31, 37]], 0), ([[20, 26, 31, 37], [0, 5, 11, 17]], 20)):
        _, mask, n = ST.ransac_with_samples(tie_p1, tie_p2, tie_ok, torch.tensor(rows, device=dev))
        need(int(n) == 20 and bool(mask[first:first + 20].all()),
             f"planted RANSAC tie: {int(n)} inliers, not the first hypothesis's")

    # The cylindrical driver on the card: the JAX test's three crops of
    # frame 05, focal 2000, its capacities and bounds.
    tex = imgs35[5]
    crops = [tex[:, 0:360], tex[:, 140:500], tex[:, 280:640]]
    cgraph = StitchGraph(center_index=1, center_rotation=0.0, images_count=3,
                         edges=((0, 1), (1, 2)))
    diag = {}
    before = dict(blends)
    cpano, cyl_s = host_s(lambda: stitch_scene_cylindrical(
        crops, cgraph, SiftConfig(**CYL_CAPS), focal=2000.0, diagnostics=diag, device=dev))
    cyl_blend = blend_ran(before)
    pano_ok(cpano, "cylindrical", cyl_blend)
    oh, ow, ot = ST._canvas_layout(diag["warped"], diag["homographies"])
    cyl_ci = BL.overlap_consistency(diag["warped"], [ot @ h for h in diag["homographies"]],
                                    oh, ow, device=dev)
    need(cpano.shape[0] >= 400 and cpano.shape[1] >= 560 and cpano.std() > 10 and cyl_ci < 6.0,
         f"cylindrical: shape {cpano.shape}, std {cpano.std()}, overlap consistency {cyl_ci}")
    emit(dict(phase="stitch", nvidia_smi=smi, frames=SCENE_FRAMES, frame_hw=list(imgs35[0].shape[:2]),
              caps=dict(extrema_cap=stcfg.extrema_cap, kp_cap=stcfg.kp_cap, ori_cap=stcfg.ori_cap),
              command_caps=dict(extrema_cap=scfg_default.extrema_cap, kp_cap=scfg_default.kp_cap,
                                ori_cap=scfg_default.ori_cap),
              clipped_at_command_caps=clipped_default, command_warnings=sub_warnings, keypoints_at_command_caps=default_kp,
              graph=f"chain, center {mid}", command_line=sub_line, in_process_line=cli_line,
              launches=launches["stitch"], cli_blend=cli_blend,
              cli_in_process_s=cli_stitch_s, subprocess_wall_s=stitch_wall_s,
              subprocess_png_equals_in_process=bool(np.array_equal(sub_png, cli_png)),
              library_png_equals_cli=bool(np.array_equal(lib_png, cli_png)),
              keypoints=scene_kp, oracle_keypoints=oracle_kp,
              frames_at_oracle_count=sum(a == b for a, b in zip(scene_kp, oracle_kp)),
              chain_matches=chain_n, chain_matches_f64=list(CHAIN_MATCHES_F64),
              edges_at_f64_count=sum(a == b for a, b in zip(chain_n, CHAIN_MATCHES_F64)),
              ransac_inliers={f"{i}-{p}": n for (i, p), n in tree_inl.items()},
              canvas_hw=[c_h, c_w], scene_blend=scene_blend, scene_nonblack_share=scene_cover,
              scene_max=float(pano35.max()), scene_share_above_255=float((pano35 > 255).mean()),
              png_write_s=png_write_s, detect_s=detect_s, detect_covering_caps_s=detect_covering_s, edge_solve_s=edge_s, composite_s=compose_s, gains_s=gains_s,
              edge_solve_syncs=sync_kinds,
              frames_00_04=dict(canvas_hw=list(pano5_card.shape[:2]), blend=blend5,
                                composite_s=compose5_s,
                                corner_max_err_px=corner_err, within_1_grey_share=within1,
                                max_abs_diff=float(diff5.max())),
              cylindrical=dict(hw=list(cpano.shape[:2]), std=float(cpano.std()),
                               overlap_consistency=cyl_ci, edge_residual_px=diag["edge_residual_px"],
                               focal=diag["focal"], blend=cyl_blend, seconds=cyl_s)))
    del kps35, kps5, kps5_cpu, pano35, pano5_card, pano5_cpu, cpano, diag

    # -- phase 8d: the evaluation tools (scene audit, SfM harness, scaling
    # harness) as a user runs them, against the stitch phase's counts ---------
    launches["tools"] = tools_phase(dev, smi, scene_kp, chain_n, octaves, zero_counts,
                                    read_counts)

    # -- phase 8e: kernels D, F and B against their plain versions at the SfM
    # path's shapes: one rendered 320 x 240 frame doubled to 480 x 640 at
    # batch 1 (D, its blur; F, every octave into its own plan's buffers) and
    # two frames' descriptors, ori_cap 2048 lanes each (B) --------------------
    sfm_cfg = SiftConfig(**SFM_CAPS)
    shks, sthr = blur_half_kernels(sfm_cfg), sfm_cfg.extremum_threshold()
    spre = gaussian_half_kernel(math.sqrt(sfm_cfg.init_sigma * sfm_cfg.init_sigma - 1))
    sframes, _ = port_script("torch_sfm_eval").render_sequence(
        ts=sfm_sequences()[f"sweep-{SFM_FRAMES}"][:2])
    simg = S.as_batch(sframes[0][None], sfm_cfg, dev)
    soct = S.octaves_for(simg, sfm_cfg)
    sgray = upsample_bilinear(to_grayscale(simg).to(sfm_cfg.dtype), 2, 2).contiguous()
    sseeds = [separable_blur_kernel(sgray, spre)]
    d_err = max(d_err, same(sseeds[0], separable_blur(sgray, spre), "kernel D sfm initial vs plain"))
    d_plan(tuple(sgray.shape), spre)
    same(sseeds[0], compute_initial_image(simg, sfm_cfg), "kernel D sfm initial vs the path's seed")
    for o in range(soct - 1):
        g_plain = octave_blur_plain(sseeds[-1], shks)[0]
        sseeds.append(downsample_nearest_x2(g_plain[:, g_plain.shape[1] - 3]).contiguous())
    splan = S.front_twin_plan(sfm_cfg, soct, *sseeds[0].shape[1:])
    need(all(o[3] for o in splan.octaves), f"sfm front-twin plan {splan.octaves}")
    sf_args = [(sd, shks, sthr, gbase, st, splan.blk, splan.g_l0, splan.g_nl, pkbase)
               for sd, (_, _, st, _, _, gbase), pkbase
               in zip(sseeds, splan.octaves, splan.pk_bases)]
    sbufs = [(torch.zeros((1, splan.g_total, 2 * splan.blk), device=dev),
              torch.zeros((1, splan.pk_total, 128), device=dev)) for _ in range(2)]
    for o, (got, ref) in enumerate(zip(run_f(octave_front_twin, *sbufs[0], sf_args),
                                       run_f(octave_front_twin_plain, *sbufs[1], sf_args))):
        for name, a, b in zip(("mask", "counts", "down"), got, ref):
            f_err = max(f_err, same(a, b, f"kernel F sfm octave {o} {name} vs plain"))
    f_err = max(f_err, same(sbufs[0][0], sbufs[1][0], "kernel F sfm gauss twin rows vs plain"),
                same(sbufs[0][1], sbufs[1][1], "kernel F sfm cube-packed rows vs plain"))
    skp = S.detect_and_describe_batch(S.as_batch(np.stack(sframes), sfm_cfg, dev), sfm_cfg,
                                      device=dev)
    need(skp.desc.shape[1] == SFM_CAPS["ori_cap"], f"sfm descriptors {tuple(skp.desc.shape)}")
    for name, a, b in zip(("best", "second", "idx"),
                          top2(skp.desc[0:1], skp.desc[1:2], skp.valid[1:2]),
                          top2_plain(skp.desc[0:1], skp.desc[1:2], skp.valid[1:2])):
        b_err = max(b_err, same(a, b, f"kernel B sfm descriptors {name} vs plain"))
    emit(dict(phase="sfm_kernels_vs_plain", frame_hw=list(sframes[0].shape[:2]),
              doubled_hw=list(sgray.shape[1:]), octaves=soct,
              octave_hw=[list(sd.shape[1:]) for sd in sseeds], top2_shape=list(skp.desc.shape[1:]),
              keypoints=skp.valid.sum(1).tolist(), bit_equal=True))
    del sbufs, skp, sseeds

    # -- phase 8f: incremental SfM (``run_sfm``) on sweep-50 and bigloop-97,
    # counted: D and F for every frame, B for every matched pair -----------------
    launches["sfm"] = sfm_phase(dev, smi, zero_counts, read_counts,
                                lambda img: S.octaves_for(S.as_batch(img[None], cfg, dev), cfg))

    # -- phase 8g: the multi-device layer on ranks that share the card, counted
    # per rank: D 1 and F 8 (detection), B 1 a match call, C 8, D 1 and H 24
    # (spatial); then NCCL at world size 1 ------------------------------------
    launches["parallel"] = parallel_phase(dev, smi, cfg, scfg, frames, octaves, main_kp,
                                          oracle_set, t_script)

    # -- phase 9: timing of the sweeps, the stages of the front-twin and the
    # front route, the other routes and the kernels ----------------------------
    def sweep(c=cfg, route=None):
        if route is None:
            out = S.detect_and_describe_batch(imgs, c, device=dev)
        else:
            out, _ = S.run_route(imgs, c, route)
        m = match_descriptors(out.desc[0::2], out.valid[0::2], out.desc[1::2],
                              out.valid[1::2], cfg.ratio_threshold, device=dev)
        return out, m

    # The main path through its entry point and the front route through
    # ``run_route``, in turns (twin, front, front, twin), so that a drift of
    # the host's pace falls on both.
    turns = [host_ms(lambda r=r: sweep(route=r), TIMED_SWEEPS)
             for r in (None, "front", "front", None)]
    sweep_ms, front_sweep_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    xla_ms = host_ms(lambda: sweep(xcfg), TIMED_SWEEPS)
    window5_ms = host_ms(lambda: sweep(wcfg), TIMED_SWEEPS)
    staged_ms = host_ms(lambda: [S.detect_stages(o["input"], scfg, octaves, device=dev)
                                 for o in (o1, o2)], 2) / 2

    def stage_times(route):
        """Stage-synchronised host times of one route's stages, ms."""
        timer = StageTimer()

        def timed(name, fn):
            torch.cuda.synchronize()
            with timer.stage(name):
                out = fn()
                torch.cuda.synchronize()
            return out

        for _ in range(TIMED_SWEEPS):
            if route == "front_twin":
                gsp, dsp, ms_, cs = timed("front_twin", lambda: S.front_twin(imgs, cfg))
            else:
                gs, ds, ms_, cs = timed("front", lambda: S.front(imgs, cfg))
                dsp = timed("dog_space", lambda: StackSpace.build(ds))
                gsp = timed("gauss_space", lambda: StackSpace.build(gs))
                del gs, ds
            kpr, _ = timed("detect_refine", lambda: S.detect_refine(dsp, ms_, cs, cfg))
            del dsp, ms_, cs
            cand, _ = timed("orient", lambda: S.orient(gsp, kpr, cfg))
            allkp = timed("dedup", lambda: S.dedup(cand, cfg))
            fin = timed("describe", lambda: S.describe(gsp, allkp, cfg))
            del gsp
            timed("match", lambda: match_descriptors(
                fin.desc[0::2], fin.valid[0::2], fin.desc[1::2], fin.valid[1::2],
                cfg.ratio_threshold, device=dev))
        return {name: t * 1e3 / TIMED_SWEEPS for name, t in timer.totals.items()}

    # The stages too in turns; each route's two turns are averaged.
    st_turns = [stage_times(r) for r in ("front_twin", "front", "front", "front_twin")]

    def mean_stages(a, b):
        return {k: (a[k] + b[k]) / 2 for k in a}

    emit(dict(phase="timing", batch=BATCH, frames_per_s=BATCH / sweep_ms * 1e3,
              sweep_ms=sweep_ms, sweep_ms_turns=[turns[0], turns[3]],
              stage_ms=mean_stages(st_turns[0], st_turns[3]),
              stage_ms_sum_turns=[sum(st_turns[0].values()), sum(st_turns[3].values())],
              front_route_sweep_ms=front_sweep_ms, front_route_sweep_ms_turns=turns[1:3],
              front_route_stage_ms=mean_stages(st_turns[1], st_turns[2]),
              front_route_stage_ms_sum_turns=[sum(st_turns[1].values()),
                                              sum(st_turns[2].values())],
              xla_route_sweep_ms=xla_ms,
              window5_route_sweep_ms=window5_ms,
              staged_ms_per_frame=staged_ms,
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30))

    # -- phase 9b: the radius classes of orientation and descriptors against
    # the worst-case window on the main path's buffers, in turns --------------
    gsp, dsp, ms_, cs = S.front_twin(imgs, cfg)
    kpr, _ = S.detect_refine(dsp, ms_, cs, cfg)
    del dsp, ms_, cs
    cand_c, peaks_c = orient_plain(gsp, kpr, cfg)
    cand_w, peaks_w = orient_plain(gsp, kpr, cfg, classes=False)
    for f in ("valid", "x", "y", "size", "octave", "layer"):
        same(getattr(cand_c, f), getattr(cand_w, f), f"orientation candidates {f}, classes "
             "vs the worst-case window")
    need(int(peaks_c) == int(peaks_w), "ori_slots_max, classes vs the worst-case window")
    allkp = S.dedup(compact(cand_c, cfg.ori_cap), cfg)
    desc_c = compute_descriptors_plain(gsp, allkp, cfg)
    desc_w = compute_descriptors_plain(gsp, allkp, cfg, classes=False)
    ddiff = (desc_c.int() - desc_w.int())[allkp.valid].abs()

    def stage_sweep(c):
        """The main path's stages and the matcher with or without classes."""
        g, d, m, n = S.front_twin(imgs, cfg)
        k, _ = S.detect_refine(d, m, n, cfg)
        del d, m, n
        a = S.dedup(compact(orient_plain(g, k, cfg, classes=c)[0], cfg.ori_cap), cfg)
        desc = compute_descriptors_plain(g, a, cfg, classes=c)
        match_descriptors(desc[0::2], a.valid[0::2], desc[1::2], a.valid[1::2],
                          cfg.ratio_threshold, device=dev)

    def stage_pair(c):
        """(orient stage, describe stage, sweep) ms."""
        return (host_ms(lambda: compact(orient_plain(gsp, kpr, cfg, classes=c)[0], cfg.ori_cap),
                        TIMED_SWEEPS),
                host_ms(lambda: compute_descriptors_plain(gsp, allkp, cfg, classes=c),
                        TIMED_SWEEPS),
                host_ms(lambda: stage_sweep(c), TIMED_SWEEPS))

    cls_turns = {True: [], False: []}
    for c in (True, False, False, True):  # classes, worst case, worst case, classes
        cls_turns[c].append(stage_pair(c))

    def samples(radii, counts):
        return sum(n * (2 * r + 1) ** 2 for r, n in zip(radii, counts))

    ori_radii, desc_radii = ori_radius_classes(cfg), desc_radius_classes(cfg)
    ori_n = ori_class_counts(gsp, kpr, cfg)
    desc_n = desc_class_counts(gsp, allkp, cfg)
    emit(dict(phase="radius_classes", batch=BATCH,
              orient=dict(radii=ori_radii, lanes=ori_n,
                          samples_share=samples(ori_radii, ori_n) / samples(
                              [ori_radii[-1]], [sum(ori_n)]),
                          ms_classes=[t[0] for t in cls_turns[True]],
                          ms_worst_case=[t[0] for t in cls_turns[False]]),
              describe=dict(radii=desc_radii, lanes=desc_n,
                            samples_share=samples(desc_radii, desc_n) / samples(
                                [desc_radii[-1]], [sum(desc_n)]),
                            ms_classes=[t[1] for t in cls_turns[True]],
                            ms_worst_case=[t[1] for t in cls_turns[False]]),
              sweep_ms_classes=[t[2] for t in cls_turns[True]],
              sweep_ms_worst_case=[t[2] for t in cls_turns[False]],
              turns="classes, worst case, worst case, classes; each the mean of "
                    f"{TIMED_SWEEPS} calls; a sweep is the main path's stages and the "
                    "matcher called one by one",
              candidates_identical=True,
              pori_max_abs_diff=float((cand_c.pori - cand_w.pori)[cand_c.valid].abs().max()),
              desc_bytes=int(ddiff.numel()), desc_bytes_differ=int((ddiff != 0).sum()),
              desc_max_abs_diff=int(ddiff.max())))
    del gsp, kpr, cand_c, cand_w, allkp, desc_c, desc_w

    f_ms = cuda_ms(lambda: run_f(octave_front_twin, gk, pkk), KERNEL_REPS)
    f_plain_ms = cuda_ms(lambda: run_f(octave_front_twin_plain, gk, pkk), 3)
    # Each octave's launch alone: the small octaves show what a launch costs.
    f_octave_ms = [cuda_ms(lambda a=a: run_f(octave_front_twin, gk, pkk, [a]), KERNEL_REPS)
                   for a in f_args]
    fill_ms = cuda_ms(twin_buffers, 5)
    f_bound, f_by = bound(*f_times)
    g_ms = cuda_ms(lambda: [cube_pack_rows(d, st, out=pkg, base=pb) for d, st, pb in g_args],
                   KERNEL_REPS)
    g_plain_ms = cuda_ms(lambda: [cube_rows_plain(d, st) for d, st, _ in g_args], 3)
    # The library yardsticks: one ``copy_`` per octave or volume from an
    # overlapping ``as_strided`` view of the input, which is padded outside
    # the timed window; each first held against the kernel's output.
    g_pads = [(cube_padded(d, st), st, pb) for d, st, pb in g_args]
    g_lib = torch.zeros_like(pkk)
    for dp, st, pb in g_pads:
        library_cube(dp, st, g_lib, pb)
    same(g_lib, pkk, "kernel G's library yardstick vs kernel F's buffer")
    del g_lib
    g_lib_ms = cuda_ms(lambda: [library_cube(dp, st, pkg, pb) for dp, st, pb in g_pads],
                       KERNEL_REPS)
    g_bound, g_by = bound(*g_times)
    h_mats = [v.reshape(-1, v.shape[-1]) for v in h_vols]
    h_ms = cuda_ms(lambda: build_multi_rows(h_vols, 128), KERNEL_REPS)
    h_dev_ms = graph_ms(lambda: build_multi_rows(h_vols, 128), KERNEL_REPS)
    h_single_ms = cuda_ms(lambda: [twin_rows_2d(m, 128) for m in h_mats], KERNEL_REPS)
    h_plain_ms = cuda_ms(lambda: [twin_rows_2d_plain(m, 128) for m in h_mats], 5)
    h_pads = [torch.nn.functional.pad(m, (0, (-(-m.shape[1] // 128) + 1) * 128 - m.shape[1]))
              for m in h_mats]
    same(library_rows(h_pads, 128), build_multi_rows(h_vols, 128).rows,
         "kernel H's library yardstick vs build_multi_rows")
    h_lib_ms = cuda_ms(lambda: library_rows(h_pads, 128), KERNEL_REPS)
    del h_pads
    h_bound, h_by = bound(*h_times)
    c_ms = cuda_ms(lambda: [octave_blur(s, hks) for s in seeds], KERNEL_REPS)
    c_plain_ms = cuda_ms(lambda: [octave_blur_plain(s, hks) for s in seeds], 3)
    frame_seeds = [s[:1].contiguous() for s in seeds]
    c_frame_ms = cuda_ms(lambda: [octave_blur(s, hks) for s in frame_seeds], KERNEL_REPS)
    c_bound, c_by = bound(*c_times)
    d_ms = cuda_ms(lambda: separable_blur_kernel(gray, pre), KERNEL_REPS)
    d_dev_ms = graph_ms(lambda: separable_blur_kernel(gray, pre), KERNEL_REPS)
    frame = gray[:1].contiguous()
    d_frame_ms = cuda_ms(lambda: separable_blur_kernel(frame, pre), KERNEL_REPS)
    d_frame_dev_ms = graph_ms(lambda: separable_blur_kernel(frame, pre), KERNEL_REPS)
    d_plain_ms = cuda_ms(lambda: separable_blur(gray, pre), 5)
    need(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    d_lib_err = (library_blur(gray, pre) - initial).abs().max().item()
    d_lib_ms = cuda_ms(lambda: library_blur(gray, pre), 5)
    d_bound, d_by = bound(*d_times)
    e_ms = cuda_ms(lambda: [twin_rows_strips(st, S.TWIN_BLK) for st in (gs16, ds16)],
                   KERNEL_REPS)
    e_dev_ms = graph_ms(lambda: [twin_rows_strips(st, S.TWIN_BLK) for st in (gs16, ds16)],
                        KERNEL_REPS)
    e_plain_ms = cuda_ms(lambda: [twin_rows_strips_plain(st, S.TWIN_BLK) for st in (gs16, ds16)],
                         3)
    e_pads = [twin_padded(st, S.TWIN_BLK) for st in (gs16, ds16)]
    for a, st in zip(e_pads, (gs16, ds16)):
        same(library_twin(*a, S.TWIN_BLK), twin_rows_strips(st, S.TWIN_BLK).rows,
             "kernel E's library yardstick vs the kernel")
    e_lib_ms = cuda_ms(lambda: [library_twin(*a, S.TWIN_BLK) for a in e_pads], KERNEL_REPS)
    del e_pads
    e_bound, e_by = bound(*e_times)
    emit(dict(phase="kernel_timing", octave_blur_ms=c_ms, octave_blur_plain_ms=c_plain_ms,
              octave_blur_one_frame_ms=c_frame_ms,
              blur_pass_ms=d_ms, blur_pass_device_ms=d_dev_ms,
              blur_pass_one_frame_ms=d_frame_ms, blur_pass_one_frame_device_ms=d_frame_dev_ms,
              blur_pass_plain_ms=d_plain_ms,
              library_blur_ms=d_lib_ms, top2_ms=b_ms, top2_device_ms=b_dev_ms,
              top2_one_pair_ms=b_pair_ms, top2_one_pair_device_ms=b_pair_dev_ms,
              top2_one_pair_bound_ms=b_pair_bound,
              library_blur_max_abs_err=d_lib_err, twin_rows_ms=e_ms,
              twin_rows_device_ms=e_dev_ms, twin_rows_plain_ms=e_plain_ms,
              twin_rows_library_ms=e_lib_ms, octave_front_twin_ms=f_ms,
              octave_front_twin_plain_ms=f_plain_ms, octave_front_twin_ms_by_octave=f_octave_ms,
              front_twin_zero_fill_ms=fill_ms,
              cube_pack_ms=g_ms, cube_pack_plain_ms=g_plain_ms, cube_pack_library_ms=g_lib_ms,
              build_multi_rows_kernel_ms=h_ms, build_multi_rows_device_ms=h_dev_ms,
              twin_rows_2d_single_calls_ms=h_single_ms, twin_rows_2d_plain_ms=h_plain_ms,
              twin_rows_2d_library_ms=h_lib_ms))

    # -- phase 9b': kernels I, J and K at the benchmark cells' shapes ---------------
    i_cells = describe_phase(dev, smi)
    j_cells = detect_phase(dev, smi)
    k_cells = orient_phase(dev, smi)

    # -- phase 9c: the streaming path: the loader, uint8 frames to the card,
    # the bench and the scene script, counted ------------------------------------
    launches.update(stream_phase(dev, smi, cfg, frames, main_kp, oracle_set, octaves,
                                 zero_counts, read_counts))

    def by_path(name):
        return {path: c[name] for path, c in launches.items()}

    rows = [
        dict(name="octave_front", route="cuda",
             source="sift_tpu_torch/csrc/octave_front.cu",
             replaces="sift_tpu/ops/pallas_pyramid.py:240",
             launches=launches["front"]["octave_front"],
             max_abs_err=max(worst, wide_err["octave_front"]),
             ms=a_ms, plain_ms=a_plain_ms, bound_ms=a_bound, bound_by=a_by,
             library_ms=None, launches_by_path=by_path("octave_front")),
        dict(name="top2", route="cuda", source="sift_tpu_torch/csrc/top2.cu",
             replaces="sift_tpu/ops/pallas_match.py:90",
             launches=launches["main"]["top2"], max_abs_err=float(max(b_err, wide_err["top2"])),
             ms=b_ms, plain_ms=b_plain_ms, bound_ms=b_bound, bound_by=b_by,
             library_ms=b_lib_ms, launches_by_path=by_path("top2"), device_ms=b_dev_ms,
             one_pair_1286x1430_ms=b_pair_ms, one_pair_1286x1430_device_ms=b_pair_dev_ms,
             one_pair_1286x1430_bound_ms=b_pair_bound),
        # ``launches`` is the count on the path that brought the kernel in:
        # the main path (the front-twin route) for F, B and D, the front route
        # for A, the window-5 route for C and E (batch 16), the fallback run
        # for G, the staged path for H; ``launches_by_path`` has them all
        # (``wide``: phase ``wide_fallback``'s entry point, where G's
        # ``wide_*`` numbers come from).
        # No single PyTorch call computes an octave (A, C, F): ``library_ms``
        # is null there.  E, G and H's yardstick is one ``copy_`` per octave
        # or volume from an overlapping ``as_strided`` view of the input,
        # padded outside the timed window (E adds a ``zero_`` per gap; G's
        # writes only the lanes that hold values).
        dict(name="octave_blur", route="cuda",
             source="sift_tpu_torch/csrc/octave_front.cu",
             replaces="sift_tpu/ops/pallas_pyramid.py:675",
             launches=launches["window5"]["octave_blur"], max_abs_err=c_err,
             ms=c_ms, plain_ms=c_plain_ms, bound_ms=c_bound, bound_by=c_by,
             library_ms=None, launches_by_path=by_path("octave_blur")),
        dict(name="blur_pass", route="cuda", source="sift_tpu_torch/csrc/blur_pass.cu",
             replaces="sift_tpu/ops/pallas_blur.py:121",
             launches=launches["main"]["blur_pass"],
             max_abs_err=max(d_err, wide_err["blur_pass"]),
             ms=d_ms, plain_ms=d_plain_ms, bound_ms=d_bound, bound_by=d_by,
             library_ms=d_lib_ms, launches_by_path=by_path("blur_pass"),
             device_ms=d_dev_ms),
        dict(name="twin_rows", route="cuda", source="sift_tpu_torch/csrc/twin_rows.cu",
             replaces="sift_tpu/ops/pallas_relayout.py:135",
             launches=launches["window5"]["twin_rows"], max_abs_err=e_err,
             ms=e_ms, plain_ms=e_plain_ms, bound_ms=e_bound, bound_by=e_by,
             library_ms=e_lib_ms, launches_by_path=by_path("twin_rows"), device_ms=e_dev_ms),
        # F's time covers the 8 octaves of a batch-16 pyramid into zeroed
        # buffers (their zero fill is front_twin_zero_fill_ms), G's the same
        # octaves' DoG stacks, H's one frame's 16 volumes at blk 128 through
        # build_multi_rows (one launch), beside the same 16 as single calls
        # (the staged path's pattern).
        dict(name="octave_front_twin", route="cuda",
             source="sift_tpu_torch/csrc/octave_front.cu",
             replaces="sift_tpu/ops/pallas_pyramid.py:513",
             launches=launches["main"]["octave_front_twin"],
             max_abs_err=max(f_err, wide_err["octave_front_twin"]),
             ms=f_ms, plain_ms=f_plain_ms, bound_ms=f_bound, bound_by=f_by,
             library_ms=None, launches_by_path=by_path("octave_front_twin")),
        dict(name="cube_pack", route="cuda", source="sift_tpu_torch/csrc/cube_pack.cu",
             replaces="sift_tpu/ops/pallas_relayout.py:195",
             launches=launches["fallback"]["cube_pack"],
             max_abs_err=max(g_err, wide_err["cube_pack"]),
             ms=g_ms, plain_ms=g_plain_ms, bound_ms=g_bound, bound_by=g_by,
             library_ms=g_lib_ms, launches_by_path=by_path("cube_pack"),
             wide_shape=g_wide["shape"], wide_ms=g_wide["ms"], wide_plain_ms=g_wide["plain_ms"],
             wide_bound_ms=g_wide["bound_ms"], wide_bound_by=g_wide["bound_by"],
             wide_library_ms=g_wide["library_ms"]),
        dict(name="twin_rows_2d", route="cuda", source="sift_tpu_torch/csrc/twin_rows.cu",
             replaces="sift_tpu/ops/pallas_relayout.py:29",
             launches=launches["staged"]["twin_rows_2d"], max_abs_err=h_err,
             ms=h_ms, plain_ms=h_plain_ms, bound_ms=h_bound, bound_by=h_by,
             library_ms=h_lib_ms, launches_by_path=by_path("twin_rows_2d"), device_ms=h_dev_ms,
             sixteen_single_calls_ms=h_single_ms),
        # Kernel I replaces no TPU kernel (the JAX package describes with
        # XLA): ms and plain_ms at resident_b16's shapes, cli_pair's beside;
        # max_abs_err against the plain chain over both cells' bytes.
        dict(name="describe", route="cuda", source="sift_tpu_torch/csrc/describe.cu",
             replaces=None, launches=launches["main"]["describe"],
             max_abs_err=max(c["max_abs_err"] for c in i_cells.values()),
             ms=i_cells["resident_b16"]["ms"], plain_ms=i_cells["resident_b16"]["plain_ms"],
             bound_ms=i_cells["resident_b16"]["bound_ms"],
             bound_by=i_cells["resident_b16"]["bound_by"], library_ms=None,
             launches_by_path=by_path("describe"),
             device_ms=i_cells["resident_b16"]["device_ms"], cli_pair=i_cells["cli_pair"]),
        # Kernel J replaces no TPU kernel either (the JAX package detects and
        # refines with XLA); as I's row, resident_b16's shapes, cli_pair's
        # beside; max_abs_err against the plain chain over every field.
        dict(name="detect", route="cuda", source="sift_tpu_torch/csrc/detect.cu",
             replaces=None, launches=launches["main"]["detect"],
             max_abs_err=max(c["max_abs_err"] for c in j_cells.values()),
             ms=j_cells["resident_b16"]["ms"], plain_ms=j_cells["resident_b16"]["plain_ms"],
             bound_ms=j_cells["resident_b16"]["bound_ms"],
             bound_by=j_cells["resident_b16"]["bound_by"], library_ms=None,
             launches_by_path=by_path("detect"),
             device_ms=j_cells["resident_b16"]["device_ms"], cli_pair=j_cells["cli_pair"]),
        # Kernel K replaces no TPU kernel either (the JAX package assigns
        # orientations with XLA); as I's row, resident_b16's shapes, cli_pair's
        # beside; max_abs_err: pori (rad) against the plain chain.
        dict(name="orient", route="cuda", source="sift_tpu_torch/csrc/describe.cu",
             replaces=None, launches=launches["main"]["orient"],
             max_abs_err=max(c["max_abs_err"] for c in k_cells.values()),
             ms=k_cells["resident_b16"]["ms"], plain_ms=k_cells["resident_b16"]["plain_ms"],
             bound_ms=k_cells["resident_b16"]["bound_ms"],
             bound_by=k_cells["resident_b16"]["bound_by"], library_ms=None,
             launches_by_path=by_path("orient"),
             device_ms=k_cells["resident_b16"]["device_ms"], cli_pair=k_cells["cli_pair"]),
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
