#!/usr/bin/env python3
"""Time compile-time variants of sift_tpu_torch/csrc/octave_front.cu on one
NVIDIA GPU.

    python3 scripts/tune_octave_front.py [NAME=-DFLAG,-DFLAG ...]

Each variant is the same source built with extra ``-D`` flags (for example
``r8=-DBATCH_ROWS=8`` or ``w1=-DWARPS_PER_ROW=1``), or another source file
given as ``@path`` in the flags' place (for example the parent commit's,
written out with ``git show``); ``default`` (no flag) is always first.  For every variant the script holds kernels A, C and F
against the plain versions bit for bit at the bench's eight octave shapes
(batch 16, the CAVE-01 pair x8 of tests/data), then times each kernel's
eight launches (CUDA events, warm, two rounds over all variants so that a
drift shows) and F's launch per octave.  One JSON line per variant and
round, after a line with the card's name and power limit.  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REPS = 10


def sass_sizes(so) -> list[int]:
    """Instructions of each kernel in the library (cuobjdump), [] without it."""
    try:
        out = subprocess.run(["cuobjdump", "-sass", str(so)], capture_output=True, text=True,
                             timeout=120).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    sizes = []
    for ln in out.splitlines():
        if "Function :" in ln:
            sizes.append(0)
        elif sizes and ln.lstrip().startswith("/*") and ";" in ln:
            sizes[-1] += 1
    return sizes


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tune_octave_front: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from sift_tpu_torch import SiftConfig, kernels
    from sift_tpu_torch.models import sift as S
    from sift_tpu_torch.models.pyramid import blur_half_kernels, compute_initial_image
    from sift_tpu_torch.ops.octave_blur import octave_blur, octave_blur_plain
    from sift_tpu_torch.ops.octave_front import (
        octave_front,
        octave_front_plain,
        octave_front_twin,
        octave_front_twin_plain,
    )
    from sift_tpu_torch.ops.resize import downsample_nearest_x2

    variants = [("default", [])]
    for arg in sys.argv[1:]:
        name, _, flags = arg.partition("=")
        variants.append((name, [f for f in flags.split(",") if f]))

    # Build every variant at once, one nvcc each.
    out_dir = kernels.BUILD / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in variants:
        so = out_dir / f"lib{name}.so"
        src = kernels.CSRC / "octave_front.cu"
        if flags and flags[0].startswith("@"):
            src, flags = Path(flags[0][1:]), flags[1:]
        procs[name] = (so, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *flags, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps(dict(variant=name, build_failed=log[-2000:])), flush=True)
            continue
        libs[name] = ctypes.CDLL(str(so))
        ptxas[name] = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
        ptxas[name].append(dict(sass_instructions=sass_sizes(so)))
    print(chip_smoke.smi_line(), flush=True)

    dev = torch.device("cuda")
    cfg = SiftConfig(**chip_smoke.CAPS)
    o1 = np.load(chip_smoke.DATA / "oracle_cave00.npz")
    o2 = np.load(chip_smoke.DATA / "oracle_cave01.npz")
    imgs = S.as_batch(np.stack([o1["input"], o2["input"]] * (chip_smoke.BATCH // 2)), cfg, dev)
    octaves = S.octaves_for(imgs, cfg)
    hks = blur_half_kernels(cfg)
    thr = cfg.extremum_threshold()
    seeds, refs = [compute_initial_image(imgs, cfg).contiguous()], []
    for _ in range(octaves):
        refs.append(octave_front_plain(seeds[-1], hks, thr))
        seeds.append(downsample_nearest_x2(refs[-1][0][:, len(hks) - 2]).contiguous())
    seeds = seeds[:octaves]
    shapes = [tuple(s.shape[1:]) for s in seeds]
    plan = S.front_twin_plan(cfg, octaves, *shapes[0])
    f_args = [(seed, hks, thr, gbase, st, plan.blk, plan.g_l0, plan.g_nl, pkbase)
              for seed, (_, _, st, _, _, gbase), pkbase in zip(seeds, plan.octaves, plan.pk_bases)]

    def buffers():
        return (torch.zeros((chip_smoke.BATCH, plan.g_total, 2 * plan.blk), device=dev),
                torch.zeros((chip_smoke.BATCH, plan.pk_total, 128), device=dev))

    def run_f(fn, gbuf, pkbuf, args=f_args):
        return [fn(sd, hk, t, gbuf, gb, st, blk, l0, nl, pkbuf, pb)
                for sd, hk, t, gb, st, blk, l0, nl, pb in args]

    gp, pkp = buffers()
    f_refs = run_f(octave_front_twin_plain, gp, pkp)
    gk, pkk = buffers()

    def check():
        """Names of the outputs that differ from the plain versions."""
        bad = []
        for o, seed in enumerate(seeds):
            for name, a, b in zip(("gauss", "dog", "mask", "counts"),
                                  octave_front(seed, hks, thr), refs[o]):
                if not torch.equal(a, b):
                    bad.append(f"A{o}.{name}")
            for name, a, b in zip(("gauss", "dog"), octave_blur(seed, hks), refs[o]):
                if not torch.equal(a, b):
                    bad.append(f"C{o}.{name}")
            one = seed[:1].contiguous()
            for name, a, b in zip(("gauss", "dog"), octave_blur(one, hks),
                                  octave_blur_plain(one, hks)):
                if not torch.equal(a, b):
                    bad.append(f"C{o}.frame.{name}")
        gk.zero_()
        pkk.zero_()
        for o, (got, ref) in enumerate(zip(run_f(octave_front_twin, gk, pkk), f_refs)):
            for name, a, b in zip(("mask", "counts", "down"), got, ref):
                if not torch.equal(a, b):
                    bad.append(f"F{o}.{name}")
        if not torch.equal(gk, gp):
            bad.append("F.gbuf")
        if not torch.equal(pkk, pkp):
            bad.append("F.pkbuf")
        torch.cuda.synchronize()
        return bad

    for rnd in range(2):
        for name, _ in variants:
            if name not in libs:
                continue
            kernels._LIBS["octave_front"] = libs[name]
            row = dict(variant=name, round=rnd)
            if rnd == 0:
                row["ptxas"] = ptxas[name]
                try:
                    row["differs"] = check()
                except RuntimeError as e:  # a launch the variant's launcher refused
                    row["error"] = str(e)
                    del libs[name]
                    print(json.dumps(row), flush=True)
                    continue
            row["a_ms"] = chip_smoke.cuda_ms(lambda: [octave_front(s, hks, thr) for s in seeds], REPS)
            row["c_ms"] = chip_smoke.cuda_ms(lambda: [octave_blur(s, hks) for s in seeds], REPS)
            row["f_ms"] = chip_smoke.cuda_ms(lambda: run_f(octave_front_twin, gk, pkk), REPS)
            row["f_ms_by_octave"] = [chip_smoke.cuda_ms(lambda a=a: run_f(octave_front_twin, gk, pkk, [a]), REPS)
                                     for a in f_args]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
