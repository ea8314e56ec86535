"""The readings that set the SfM cells' limits (not part of a run).

    python3 -m benchmark.control_sfm --workload <cell> --seed <n> [--streams 24] \
        [--steps 4] [--faults] [--tf32]
    python3 -m benchmark.control_sfm --workload <cell> --seed <n> \
        --program dense_float32|dense_tf32 [--seconds 6]

Renders the run's trajectories as the cell's client does (``--seed``) and
runs ``models/sfm.run_sfm`` on each, once per RANSAC stream: stream s
draws every RANSAC's samples with its seed plus 7919 s (a sound program
whose rounding reorders the lanes draws other hypotheses, and RANSAC's
outcome is chaotic in them).  One JSON line per run: the trajectory error
and the frames left unregistered as the judge reads them (``Tally``), and
for the first ``--steps`` runs the last ``ba_solve``'s first step against
the dense float64 step: the program's, the dense step in float32 (a
sound reordering: the lower reading) and in TF32 (the nearest precision
below the configuration's: the upper reading), and why the request would
fail (``ba_faults``).  ``--faults``: also the planted faults (fx scaled
by 1.05, the bundle adjustment skipped, one registered pose zeroed) on
stream 0; ``--tf32``: the whole program with TF32 matrix products.
``--program``: one run of the cell through ``harness.run_cell``, the
judged step computed by the dense reference in float32 or TF32 in the
program's place; the line says which trajectory the judge compared and
whether the run came out correct.  Needs the card, as ``benchmark.run``
does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.clients import sfm as client
from benchmark.reference import sfm_plain

STREAM = 7919


@contextlib.contextmanager
def stream(s: int):
    """Every RANSAC of the program draws with its seed + ``STREAM * s``."""
    from sift_tpu_torch.models import geometry

    draw = geometry.sample_choice  # the homography's sampler calls it too
    geometry.sample_choice = lambda valid, k, m, seed=0: draw(valid, k, m, seed + STREAM * s)
    try:
        yield
    finally:
        geometry.sample_choice = draw


@contextlib.contextmanager
def fault(name: str | None):
    from sift_tpu_torch.models import sfm

    saved = dict(run_sfm_from_matches=sfm.run_sfm_from_matches, ba_solve=sfm.ba_solve)
    if name == "focal_off":
        def wrong(uvs, pm, intrinsics, *a, **k):
            k2 = np.array(intrinsics, np.float64)
            k2[0, 0] *= 1.05
            return saved["run_sfm_from_matches"](uvs, pm, k2, *a, **k)
        sfm.run_sfm_from_matches = wrong
    elif name == "ba_skipped":
        sfm.ba_solve = lambda pr, *a, **k: (pr.cams, pr.points, {"cost_trace": [0.0]})
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(sfm, n, f)


def readings(cell: harness.Cell, seq: dict, traj: int, s: int, dev, steps: bool,
             fault_name: str | None = None) -> dict:
    from sift_tpu_torch.config import SiftConfig
    from sift_tpu_torch.models.sfm import run_sfm

    cfg = SiftConfig(**cell.config["sift"])
    k = sfm_plain.intrinsics(cell.config["camera"])
    with stream(s), fault(fault_name), client.kept_calls() as kept:
        t0 = time.perf_counter()
        res = run_sfm(seq["frames"], k, cfg, device=dev, **cell.config["sfm"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    poses = np.asarray(res.poses, np.float64)
    if fault_name == "pose_zeroed":
        poses[res.info["registered"][len(res.info["registered"]) // 2]] = 0.0
    tally = client.Tally()
    tally.trajectory(poses, res.info["registered"], seq["centres"])
    out = dict(trajectory=traj, stream=s, fault=fault_name, seconds=secs,
               registered=len(res.info["registered"]), points=int(res.info["n_points"]),
               observations=int(res.info["n_obs"]), tracks=int(res.info["n_tracks"]),
               loop_pairs_added=res.info.get("loop_pairs_added", 0),
               loop_closure_skipped=res.info.get("loop_closure_skipped"),
               **tally.numbers())
    out["ba_faults"] = client.ba_faults(kept["ba"])
    if steps and kept["ba"] is not None and kept["ba"]["first"] is not None:
        ba = kept["ba"]
        ref = client.reference_step(ba, k, dev)
        out["ba_step_off_pct"] = sfm_plain.step_off_pct(client.program_step(ba), ref)
    if steps and fault_name is None and "ba_step_off_pct" in out:
        out["dense_float32_off_pct"] = sfm_plain.step_off_pct(client.reference_step(
            ba, k, dev, dtype=torch.float32), ref)
        out["dense_tf32_off_pct"] = sfm_plain.step_off_pct(client.reference_step(
            ba, k, dev, dtype=torch.float32, tf32=True), ref)
        out["unknowns"] = int(6 * len(ba["problem"].cams) + 3 * len(ba["problem"].points))
        out["dense_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    return out


def dense_program(dtype, tf32: bool):
    """The judged step computed by the reference in ``dtype`` (``tf32``:
    TF32 matrix products), in the program's place."""
    def step(problem, lam, huber, dev):
        return sfm_plain.dense_step(problem, lam, huber, dev, dtype, tf32=tf32)
    return step


def judged(workload: str, seed: int, seconds: float, program: str) -> dict:
    """One run of the cell through ``harness.run_cell`` with the judged
    step computed by the reference in float32 (``dense_float32``, a sound
    reordering) or with TF32 products (``dense_tf32``, the nearest
    precision below the configuration's)."""
    step = dict(dense_float32=dense_program(torch.float32, False),
                dense_tf32=dense_program(torch.float32, True))[program]
    result, lines = harness.run_cell(workload, seed, seconds, False, hooks=dict(program=step))
    return dict(program=program, seed=seed, correct=result["correct"], compared=lines[0],
                checks=result["checks"], attempted=result["attempted"], failed=result["failed"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control_sfm")
    ap.add_argument("--workload", default="sfm_vga.loop48")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--streams", type=int, default=24)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--program", choices=("dense_float32", "dense_tf32"))
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control_sfm: no CUDA device", file=sys.stderr)
        return 2
    if args.program:
        print(json.dumps(judged(args.workload, args.seed, args.seconds, args.program)),
              flush=True)
        return 0
    dev = torch.device("cuda")
    cell = harness.Cell(args.workload)
    frames = harness.load_frames(cell.config)
    cl = client.Client(cell, frames, dev, harness.Spans(False), 0.0)
    first = next(harness.requests(cell, len(frames), args.seed))
    cl.setup(iter([first]))
    n = 0
    for s in range(args.streams):
        for traj, seq in cl.sequences.items():
            print(json.dumps(readings(cell, seq, traj, s, dev, n < args.steps)), flush=True)
            n += 1
    if args.faults:
        for name in ("focal_off", "ba_skipped", "pose_zeroed"):
            for traj, seq in cl.sequences.items():
                print(json.dumps(readings(cell, seq, traj, 0, dev, True, name)), flush=True)
    if args.tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        for traj, seq in cl.sequences.items():
            line = readings(cell, seq, traj, 0, dev, True)
            print(json.dumps(dict(line, program="tf32")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
