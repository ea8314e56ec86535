#!/usr/bin/env python3
"""Check and time kernel G (csrc/cube_pack.cu) on one NVIDIA GPU, beside an
earlier version of the source and the ``copy_`` yardstick.

    python3 scripts/ab_cube_pack.py [--parent DIR]

``--parent DIR`` names a directory that holds an earlier ``cube_pack.cu``
with the same interface (``cube_pack_launch(d, buf, B, n, H, W, ls,
rows_total, base, stream)``), for example the parent commit's source
written out with ``git show`` into a directory that ``.gitignore`` lists.
The current source is built by the package (``kernels.load``), the
parent's by nvcc beside it.

Shapes (random DoG values from a seed): the 8 DoG stacks of a batch-16
sweep of 1280 x 960 initial images at the front-twin plan's strips and
bases (``chip_smoke.py``'s kernel-G shapes), the demo pair's (batch 2,
1510 x 998: odd widths, so the 4-byte staging runs) and the wide fallback
octave's stack (2, 5, 960, 20480) at strip 128.  Checks, bit for bit
(``chip_smoke.check_cube_launch``): each version into a NaN-filled shared
buffer at each octave's base, against ``cube_rows_plain`` on the region,
every row outside it still NaN.  A
failed check exits 1 before any timing.  Then the versions are timed
(CUDA events, warm; ``_graph``: the same launches replayed from a CUDA
graph, the device's time) in turns, parent, current, current, parent,
beside the yardstick: one ``copy_`` per octave from an overlapping
``as_strided`` view of the stack padded outside the timed window
(``chip_smoke.library_cube``).  One JSON line per check and timing, with
each shape's byte bound; the card's name and power limit first.  Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REPS = 20


def emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_cube_pack: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from sift_tpu_torch import SiftConfig, kernels
    from sift_tpu_torch.models import sift as S
    from sift_tpu_torch.ops import cube_pack as CP
    from sift_tpu_torch.ops.gather import cube_rows_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args()
    print(chip_smoke.smi_line(), flush=True)
    dev = torch.device("cuda")
    log = kernels.build(["cube_pack"])["cube_pack"]
    keep = ("registers", "spill", "Function properties")
    emit(dict(version="current", ptxas=[ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                                        if any(k in ln for k in keep)]))
    parent = None
    if args.parent:
        so = kernels.BUILD / "ab" / "libcube_pack-parent.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        out = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so),
                              str(args.parent / "cube_pack.cu")], capture_output=True, text=True)
        if out.returncode:
            emit(dict(version="parent", build_failed=out.stdout[-3000:] + out.stderr[-3000:]))
            return 1
        parent = ctypes.CDLL(str(so))
        p_, i_, ll_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        parent.cube_pack_launch.argtypes = [p_, p_, i_, i_, i_, i_, i_, ll_, ll_, p_]

    def parent_pack(d, strip, out, base):
        b, s, h, w = d.shape
        kernels.check(parent.cube_pack_launch(
            d.data_ptr(), out.data_ptr(), b, s, h, w, strip.bit_length() - 1, out.shape[1],
            base, torch.cuda.current_stream().cuda_stream), "parent cube_pack")

    def current_pack(d, strip, out, base):
        CP.cube_pack_rows(d, strip, out=out, base=base)

    # Each shape: (stacks, strips, bases, rows of the shared buffer).
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = SiftConfig()
    shapes = {}
    for what, bsz, (h, w) in (("stacks8", 16, (960, 1280)), ("demo", 2, (998, 1510)),
                              ("wide", 2, (960, 20480))):
        octaves = cfg.octaves_count(w, h)
        plan = S.front_twin_plan(cfg, octaves, h, w)
        octs = range(1) if what == "wide" else range(octaves)  # wide: the fallback octave
        stacks = [torch.rand((bsz, 5, plan.octaves[o][0], plan.octaves[o][1]), device=dev,
                             generator=gen) * 0.2 - 0.1 for o in octs]
        shapes[what] = (stacks, [plan.octaves[o][2] for o in octs],
                        [plan.pk_bases[o] for o in octs], plan.pk_total)
    assert shapes["wide"][1] == [128] and cube_rows_params(5, 20480)[2] == 931

    versions = {"current": current_pack}
    if parent:
        versions["parent"] = parent_pack
    bad = []
    for what, (stacks, strips, bases, total) in shapes.items():
        for name, pack in versions.items():
            try:
                chip_smoke.check_cube_launch(stacks, strips, bases, total, f"{name} {what}", pack)
            except chip_smoke.SmokeError as e:
                bad.append(str(e))
    torch.cuda.synchronize()
    emit(dict(check="bit_equal_to_plain_into_nan_filled_buffers", shapes=list(shapes),
              parent=parent is not None, differs=bad))
    if bad:
        return 1

    times, bounds = {}, {}
    for what in ("stacks8", "wide"):
        stacks, strips, bases, total = shapes[what]
        buf = torch.zeros((stacks[0].shape[0], total, 128), device=dev)
        floats_out = sum(d.shape[0] * -(-d.shape[2] // st) * st
                         * cube_rows_params(d.shape[1], d.shape[3])[2] * 128
                         for d, st in zip(stacks, strips))
        bounds[what] = dict(
            bytes=4 * (sum(d.numel() for d in stacks) + floats_out),
            bound_ms=chip_smoke.twin_bound(sum(d.numel() for d in stacks), floats_out)[0])
        args_ = list(zip(stacks, strips, bases))
        rows = {}
        for name in ["parent", "current", "current", "parent"] if parent else ["current"] * 2:
            pack = versions[name]

            def run(pack=pack):
                for d, st, pb in args_:
                    pack(d, st, buf, pb)

            rows.setdefault(name, []).append(dict(ms=chip_smoke.cuda_ms(run, REPS),
                                                  graph_ms=chip_smoke.graph_ms(run, REPS)))
        pads = [(chip_smoke.cube_padded(d, st), st, pb) for d, st, pb in args_]
        lib = torch.zeros_like(buf)
        for dp, st, pb in pads:
            chip_smoke.library_cube(dp, st, lib, pb)
        for d, st, pb in args_:
            current_pack(d, st, buf, pb)
        same = torch.equal(lib, buf)
        rows["library_copy"] = [chip_smoke.cuda_ms(
            lambda: [chip_smoke.library_cube(dp, st, lib, pb) for dp, st, pb in pads], REPS)]
        times[what] = dict(rows, library_equals_kernel=same)
        del buf, lib, pads
    for what, rows in times.items():
        emit(dict(kernel="G", shape=what, turns="parent, current, current, parent", **rows,
                  **bounds[what]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
