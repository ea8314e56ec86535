#!/usr/bin/env python3
"""Check and time kernels E and H (csrc/twin_rows.cu) on one NVIDIA GPU,
beside an earlier version of the source.

    python3 scripts/ab_twin_rows.py [--parent DIR]

``--parent DIR`` names a directory that holds an earlier ``twin_rows.cu``
with the one-octave interface (``twin_rows_launch(f, buf, B, R, W, blk,
ls, rt, base, stream)`` into a zero-filled buffer, and
``twin_rows_2d_launch(mat, out, R, W, blk, stream)``), for example the
parent commit's source written out with ``git show`` into a directory
that ``.gitignore`` lists.  The current source is built by the package
(``kernels.load``), the parent's by nvcc beside it.

Checks, bit for bit against the plain versions (random data from a seed):
kernel E at the sweep's gather spaces (batch 16, 960 x 1280 doubled, 8
octaves, 6 gauss and 5 DoG layers) and the demo pair's (batch 2, 998 x
1510), kernel H at one frame's 16 volumes of each, at blk 64 and 128,
and at single matrices; the current version through its launcher into
NaN-filled buffers (every row written), the parent through its wrappers.
A failed check exits 1 before any timing.  Then each version is timed
(CUDA events, warm) in turns, parent, current, current, parent: E both
spaces of a sweep, wrapper included; H ``build_multi_rows`` of a frame's
16 volumes and the same 16 volumes as single calls; each also as the
replay of the same calls from a CUDA graph (``_graph``: the device's
time).  With ``--parent``, then the two routes that launch E (the XLA
route and window-5, batch 16) with either version in turns.  One JSON
line per check and per timing; the card's name and power limit first.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REPS = 20
LAYERS = (6, 5)  # gauss, DoG


def emit(obj):
    print(json.dumps(obj), flush=True)


def octave_shapes(h, w, n=8):
    out = []
    for _ in range(n):
        out.append((h, w))
        h, w = h // 2, w // 2
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_twin_rows: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from sift_tpu_torch import kernels
    from sift_tpu_torch.ops import twin_rows as TR
    from sift_tpu_torch.ops.gather import build_multi_rows

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args()
    print(chip_smoke.smi_line(), flush=True)
    dev = torch.device("cuda")
    log = kernels.build(["twin_rows"])["twin_rows"]
    keep = ("registers", "spill", "Function properties")
    emit(dict(version="current", ptxas=[ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                                        if any(k in ln for k in keep)]))
    parent = None
    if args.parent:
        so = kernels.BUILD / "ab" / "libtwin_rows-parent.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        out = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so),
                              str(args.parent / "twin_rows.cu")], capture_output=True, text=True)
        if out.returncode:
            emit(dict(version="parent", build_failed=out.stdout[-3000:] + out.stderr[-3000:]))
            return 1
        parent = ctypes.CDLL(str(so))
        p_, i_, ll_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        parent.twin_rows_launch.argtypes = [p_, p_, i_, i_, i_, i_, i_, ll_, ll_, p_]
        parent.twin_rows_2d_launch.argtypes = [p_, p_, i_, i_, i_, p_]

    def parent_strips(stacks, blk):
        """The parent's wrapper: a zero-filled buffer, one launch an octave."""
        bsz = stacks[0].shape[0]
        metas, total = TR.plan(tuple(tuple(v.shape[1:]) for v in stacks), blk)
        rows = torch.zeros((bsz, total, 2 * blk), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for v, (_, ls, _, base) in zip(stacks, metas):
            kernels.check(parent.twin_rows_launch(
                v.data_ptr(), rows.data_ptr(), bsz, v.shape[1] * v.shape[2], v.shape[3], blk, ls,
                total, base, stream), "parent twin_rows")
        return rows

    def parent_2d(mat, blk):
        out = torch.empty((mat.shape[0] * -(-mat.shape[1] // blk), 2 * blk), device=dev)
        kernels.check(parent.twin_rows_2d_launch(mat.data_ptr(), out.data_ptr(), *mat.shape, blk,
                                                 torch.cuda.current_stream().cuda_stream),
                      "parent twin_rows_2d")
        return out

    def parent_multi(vols, blk):
        """The parent's build_multi_rows: one launch a volume, then a cat."""
        return torch.cat([parent_2d(v.reshape(-1, v.shape[-1]), blk) for v in vols])

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for what, bsz, (h, w) in (("sweep", 16, (960, 1280)), ("demo", 2, (998, 1510))):
        shapes = octave_shapes(h, w)
        cases[what] = [[torch.rand((bsz, s, hh, ww), device=dev, generator=gen) * 255
                        for hh, ww in shapes] for s in LAYERS]
    bad = []
    for what, spaces in cases.items():
        vols = [v[0] for stacks in spaces for v in stacks]  # one frame's 16 volumes
        for blk in (64, 128):
            for name, stacks in zip(("gauss", "dog"), spaces):
                bsz = stacks[0].shape[0]
                table = TR.strips_table(tuple(tuple(v.shape[1:]) for v in stacks), blk)
                ref = TR.twin_rows_strips_plain(stacks, blk).rows
                buf = torch.full((bsz, table.rows, 2 * blk), float("nan"), device=dev)
                TR.launch(table, stacks, buf)
                if not torch.equal(buf, ref):
                    bad.append(f"E current {what} {name} blk {blk}")
                if parent and not torch.equal(parent_strips(stacks, blk), ref):
                    bad.append(f"E parent {what} {name} blk {blk}")
            mats = [v.reshape(-1, v.shape[-1]) for v in vols]
            ref = torch.cat([TR.twin_rows_2d_plain(m, blk) for m in mats])
            table = TR.rows_table(tuple(m.shape for m in mats), blk)
            buf = torch.full((1, table.rows, 2 * blk), float("nan"), device=dev)
            TR.launch(table, mats, buf)
            if not torch.equal(buf[0], ref) or not torch.equal(build_multi_rows(vols, blk).rows,
                                                               ref):
                bad.append(f"H current {what} blk {blk}")
            for m in mats[::5]:
                if not torch.equal(TR.twin_rows_2d(m, blk), TR.twin_rows_2d_plain(m, blk)):
                    bad.append(f"H current {what} single {tuple(m.shape)} blk {blk}")
            if parent and not torch.equal(parent_multi(vols, blk), ref):
                bad.append(f"H parent {what} blk {blk}")
    torch.cuda.synchronize()
    emit(dict(check="bit_equal_to_plain", cases=list(cases), blks=[64, 128],
              parent=parent is not None, differs=bad))
    if bad:
        return 1

    gs, ds = cases["sweep"]
    vols = [v[0] for stacks in cases["sweep"] for v in stacks]
    mats = [v.reshape(-1, v.shape[-1]) for v in vols]
    versions = {"current": dict(
        E=lambda: [TR.twin_rows_strips(st, 64) for st in (gs, ds)],
        H_multi=lambda: build_multi_rows(vols, 128),
        H_single=lambda: [TR.twin_rows_2d(m, 128) for m in mats])}
    if parent:
        versions["parent"] = dict(
            E=lambda: [parent_strips(st, 64) for st in (gs, ds)],
            H_multi=lambda: parent_multi(vols, 128),
            H_single=lambda: [parent_2d(m, 128) for m in mats])
    order = ["parent", "current", "current", "parent"] if parent else ["current", "current"]
    times = {}
    for name in order:
        row = {}
        for k, fn in versions[name].items():
            row[k] = chip_smoke.cuda_ms(fn, REPS)
            row[k + "_graph"] = chip_smoke.graph_ms(fn, REPS)
        times.setdefault(name, []).append(row)
    for name, rows in times.items():
        emit(dict(kernels="E+H", version=name, ms_turns=rows))
    e_in = sum(v.numel() for st in (gs, ds) for v in st)
    e_out = sum(TR.strips_table(tuple(tuple(v.shape[1:]) for v in st), 64).rows * 16 * 128
                for st in (gs, ds))
    h_in = sum(m.numel() for m in mats)
    h_out = TR.rows_table(tuple(m.shape for m in mats), 128).rows * 256
    emit(dict(bound_ms=dict(E=chip_smoke.twin_bound(e_in, e_out)[0],
                            H=chip_smoke.twin_bound(h_in, h_out)[0])))
    if parent:
        del cases, gs, ds, vols, mats
        route_turns(dev, lambda st, blk: TR._space(
            st, blk, parent_strips(st, blk), TR.plan(tuple(tuple(v.shape[1:]) for v in st),
                                                     blk)[0]))
    return 0


def route_turns(dev, parent_space):
    """The two routes that launch kernel E, the XLA route and window-5, on
    the CAVE-01 pair x8 (chip_smoke.py's batch), with the current kernel
    and with the parent's in its place (``models/sift``'s
    ``twin_rows_strips`` swapped), in turns: host ms of detect + describe
    + match sweeps, and the keypoints of both held equal."""
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke
    from sift_tpu_torch import SiftConfig, match_descriptors
    from sift_tpu_torch.models import sift as S

    cfg = SiftConfig(**chip_smoke.CAPS)
    o = [np.load(chip_smoke.DATA / f"oracle_cave0{i}.npz")["input"] for i in (0, 1)]
    imgs = S.as_batch(np.stack(o * (chip_smoke.BATCH // 2)), cfg, dev)
    routes = {"xla_route": dataclasses.replace(cfg, use_octave_kernel=False),
              "window5": dataclasses.replace(cfg, window_size=5)}
    current = S.twin_rows_strips

    def sweep(c):
        out = S.detect_and_describe_batch(imgs, c, device=dev)
        match_descriptors(out.desc[0::2], out.valid[0::2], out.desc[1::2], out.valid[1::2],
                          c.ratio_threshold, device=dev)
        return out

    def host_ms(c, reps=5):
        sweep(c)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            sweep(c)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / reps

    times = {}
    try:
        for name, c in routes.items():
            S.twin_rows_strips = parent_space
            a = sweep(c)
            S.twin_rows_strips = current
            b = sweep(c)
            for f in ("valid", "x", "y", "desc"):
                if not torch.equal(getattr(a, f), getattr(b, f)):
                    raise SystemExit(f"{name}: the parent's kernel gives another {f}")
            for version in ("parent", "current", "current", "parent"):
                S.twin_rows_strips = parent_space if version == "parent" else current
                times.setdefault(name, {}).setdefault(version, []).append(host_ms(c))
    finally:
        S.twin_rows_strips = current
    emit(dict(routes_sweep_ms=times, turns="parent, current, current, parent; each the mean "
              "of 5 sweeps, batch 16", keypoints_equal=True))


if __name__ == "__main__":
    sys.exit(main())
