#!/usr/bin/env python3
"""Check and time kernels D (csrc/blur_pass.cu) and B (csrc/top2.cu) on one
NVIDIA GPU, beside build-time variants and an earlier version of each.

    python3 scripts/ab_blur_top2.py [--parent DIR] [NAME=KERNEL:MACRO=VALUE,... | NAME=KERNEL:@FILE ...]

``--parent DIR`` names a directory that holds an earlier ``blur_pass.cu``
(two launches a blur: ``blur_pass_launch(.., axis, stream)``) and
``top2.cu`` (``top2_launch``), for example the parent commit's sources
written out with ``git show`` into a directory that ``.gitignore`` lists.
A variant builds a copy of KERNEL's source (``blur_pass`` or ``top2``)
with the named ``#define``s rewritten, for example
``t128=blur_pass:TILE_W=128`` or ``s1=top2:MAX_SPLIT=1``, or builds
another source with the same C interface as the current one
(``prev=blur_pass:@DIR/blur_pass.cu``).  Every version is held against the plain
PyTorch version bit for bit: D at the bench's initial blur (16 x 960 x
1280, 5 taps) and one frame of it, every blur of the chain at every octave
shape of the bench (batch 16) and of the demo pair (batch 2, 998 x 1510
down to 7 x 11), every radius 0-15 on a ragged shape and on 7 x 10; B at 8
pairs of 2048 x 2048 and one pair of 1286 x 1430 with ties planted inside a
fragment, across warps, tiles and splits, and at small edge shapes.  Then
each version is timed (CUDA events, warm) in turns: the parent first and
last, the others between, twice.  One JSON line per check and per timing
round, after the card's name and power limit and ptxas's report; each
time is taken twice, as CUDA events around REPS calls from the host and
as the replay of the same REPS calls captured in a CUDA graph (``_graph``:
the device's time, without the host's launch pace).  Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
REPS = 20


def emit(obj):
    print(json.dumps(obj), flush=True)


def ptxas_lines(log: str) -> list[str]:
    return [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "stack frame" in ln]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_blur_top2: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from sift_tpu_torch import SiftConfig, kernels
    from sift_tpu_torch.config import gaussian_half_kernel
    from sift_tpu_torch.models.pyramid import blur_half_kernels
    from sift_tpu_torch.ops import blur_pass, top2 as top2_mod
    from sift_tpu_torch.ops.blur import separable_blur
    from sift_tpu_torch.ops.top2 import top2_plain

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()

    # Every version at once, one nvcc each: (kernel, name, source).
    out_dir = kernels.BUILD / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    versions = [("blur_pass", "new", kernels.CSRC / "blur_pass.cu"),
                ("top2", "new", kernels.CSRC / "top2.cu")]
    if args.parent:
        versions += [("blur_pass", "parent", args.parent / "blur_pass.cu"),
                     ("top2", "parent", args.parent / "top2.cu")]
    for v in args.variants:
        name, _, rest = v.partition("=")
        kern, _, spec = rest.partition(":")
        if spec.startswith("@"):
            versions.append((kern, name, Path(spec[1:]).resolve()))
            continue
        text = (kernels.CSRC / f"{kern}.cu").read_text()
        for assign in filter(None, spec.split(",")):
            macro, _, value = assign.partition("=")
            text, n = re.subn(rf"^#define {macro} \S+", f"#define {macro} {value}", text,
                              flags=re.M)
            if n != 1:
                raise SystemExit(f"{v}: no single '#define {macro}' in {kern}.cu")
        src = out_dir / f"{kern}-{name}.cu"
        src.write_text(text)
        versions.append((kern, name, src))
    procs = {}
    for kern, name, src in versions:
        so = out_dir / f"lib{kern}-{name}.so"
        procs[(kern, name)] = (so, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            emit(dict(version=key, build_failed=log[-3000:]))
            continue
        libs[key] = ctypes.CDLL(str(so))
        emit(dict(version=key, ptxas=ptxas_lines(log)))
    print(chip_smoke.smi_line(), flush=True)
    dev = torch.device("cuda")
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    # -- kernel D ------------------------------------------------------------
    def blur_fn(key):
        lib = libs[key]
        if key[1] == "parent":
            fn = lib.blur_pass_launch
            fn.argtypes = [p_, p_, i_, i_, i_, p_, i_, f_, i_, p_]
        else:
            fn = lib.blur_launch
            fn.argtypes = [p_, p_, i_, i_, i_, p_, i_, f_, p_]
        fn.restype = i_

        def run(img, hk):
            stream = torch.cuda.current_stream().cuda_stream
            taps, sum_w = blur_pass._taps(tuple(hk))
            out = torch.empty_like(img)
            b, h, w = img.shape
            if key[1] == "parent":
                tmp = torch.empty_like(img)
                for s, d, axis in ((img, tmp, 1), (tmp, out, 0)):
                    kernels.check(fn(s.data_ptr(), d.data_ptr(), b, h, w, taps.ctypes.data,
                                     len(taps), sum_w, axis, stream), "parent blur")
            else:
                kernels.check(fn(img.data_ptr(), out.data_ptr(), b, h, w, taps.ctypes.data,
                                 len(taps), sum_w, stream), f"blur {key[1]}")
            return out
        return run

    cfg = SiftConfig()
    pre = gaussian_half_kernel(math.sqrt(cfg.init_sigma ** 2 - 1))
    hks = blur_half_kernels(cfg)
    rng = np.random.default_rng(0)

    def rand(shape):
        return torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)).to(dev)

    def octave_shapes(h, w):
        out = []
        while min(h, w) >= 7 and len(out) < 8:
            out.append((h, w))
            h, w = h // 2, w // 2
        return out

    cases = [("initial", (16, 960, 1280), pre), ("initial_frame", (1, 960, 1280), pre)]
    for what, bsz, (h, w) in (("bench", 16, (960, 1280)), ("demo", 2, (998, 1510))):
        cases += [(f"{what}_chain_{h}x{w}_r{len(hk) - 1}", (bsz, h, w), hk)
                  for h, w in octave_shapes(h, w) for hk in hks]
    cases.append(("demo_initial", (2, 998, 1510), pre))
    for r in range(16):
        hk = gaussian_half_kernel(0.4 + 0.5 * r)[: r + 1] if r else [1.0]
        hk = (hk + [1e-3] * 16)[: r + 1]
        cases += [(f"r{r}_37x301", (3, 37, 301), hk), (f"r{r}_7x10", (1, 7, 10), hk)]
    d_keys = [k for k in libs if k[0] == "blur_pass"]
    bad = {k: [] for k in d_keys}
    for name, shape, hk in cases:
        img = rand(shape)
        ref = separable_blur(img, hk)
        for k in d_keys:
            if k[1] == "parent" and not name.startswith("initial"):
                continue
            if not torch.equal(blur_fn(k)(img, hk), ref):
                bad[k].append(name)
    torch.cuda.synchronize()
    emit(dict(kernel="D", cases=len(cases), differs={f"{k[1]}": v for k, v in bad.items()}))
    # The current launcher's plan (strip rows, CTAs an SM, SMs) at the timed shapes.
    plan_fn = libs[("blur_pass", "new")].blur_plan
    plan = {}
    for b, h, w in ((16, 960, 1280), (1, 960, 1280)):
        got = [ctypes.c_int() for _ in range(3)]
        kernels.check(plan_fn(b, h, w, len(pre), *(ctypes.byref(g) for g in got)), "blur_plan")
        plan[f"{b}x{h}x{w}"] = [g.value for g in got]
    emit(dict(kernel="D", plan=plan))

    # -- kernel B ------------------------------------------------------------
    def top2_fn(key):
        fn = libs[key].top2_launch
        fn.argtypes = [p_, p_, p_, p_, p_, p_, i_, i_, i_, p_]
        fn.restype = i_

        def run(d1, d2, v2):
            stream = torch.cuda.current_stream().cuda_stream
            pn, n = d1.shape[:2]
            out = [torch.empty((pn, n), dtype=torch.int32, device=dev) for _ in range(3)]
            kernels.check(fn(d1.data_ptr(), d2.data_ptr(), v2.data_ptr(), *(o.data_ptr() for o in out),
                             pn, n, d2.shape[1], stream), f"top2 {key[1]}")
            return out
        return run

    b_keys = [k for k in libs if k[0] == "top2"]
    shapes = {"main_8x2048x2048": (8, 2048, 2048), "pair_1286x1430": (1, 1286, 1430),
              "n10_m5": (2, 10, 5), "n63_m129": (1, 63, 129), "n64_m0": (1, 64, 0),
              "n200_m1000": (3, 200, 1000)}
    inputs = {k: [t.to(dev) for t in chip_smoke.planted_top2(*s)] for k, s in shapes.items()}
    bad = {k: [] for k in b_keys}
    for name, (d1, d2, v2) in inputs.items():
        ref = top2_plain(d1, d2, v2) if d2.shape[1] else [
            torch.full(d1.shape[:2], v, dtype=torch.int32, device=dev)
            for v in (top2_mod.HUGE_D2, top2_mod.HUGE_D2, 0)]
        for k in b_keys:
            got = top2_fn(k)(d1, d2, v2)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                bad[k].append(name)
    torch.cuda.synchronize()
    emit(dict(kernel="B", shapes=shapes, differs={k[1]: v for k, v in bad.items()},
              splits={k: top2_mod.split_for(*s) for k, s in shapes.items()}))

    # -- timing in turns -------------------------------------------------------
    main_img = rand((16, 960, 1280))
    frame_img = rand((1, 960, 1280))

    def order(keys):
        par = [k for k in keys if k[1] == "parent"]
        rest = [k for k in keys if k[1] != "parent"]
        return par + rest + rest[::-1] + par

    times = {}
    for k in order(d_keys):
        run = blur_fn(k)
        times.setdefault(("D", k[1]), []).append(dict(
            batch16=chip_smoke.cuda_ms(lambda: run(main_img, pre), REPS),
            frame=chip_smoke.cuda_ms(lambda: run(frame_img, pre), REPS),
            batch16_graph=chip_smoke.graph_ms(lambda: run(main_img, pre), REPS),
            frame_graph=chip_smoke.graph_ms(lambda: run(frame_img, pre), REPS)))
    for k in order(b_keys):
        run = top2_fn(k)
        row = {}
        for s in ("main_8x2048x2048", "pair_1286x1430"):
            row[s] = chip_smoke.cuda_ms(lambda a=inputs[s]: run(*a), REPS)
            row[s + "_graph"] = chip_smoke.graph_ms(lambda a=inputs[s]: run(*a), REPS)
        times.setdefault(("B", k[1]), []).append(row)
    for (kern, name), rows in times.items():
        emit(dict(kernel=kern, version=name, ms_turns=rows))
    emit(dict(bound_ms=dict(
        D_batch16=chip_smoke.bound(*chip_smoke.blur_bound((16, 960, 1280), pre)),
        B_main=chip_smoke.bound(*chip_smoke.top2_bound(8, 2048, 2048)),
        B_pair=chip_smoke.bound(*chip_smoke.top2_bound(1, 1286, 1430)))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
