"""Per-stage breakdown of the port's batched pipeline on the card: the
counterpart of ``scripts/perf_breakdown.py`` for sift_tpu_torch.

Times every stage of ``detect_and_describe_batch`` on its front-twin route
(the main path: kernel D for the initial image, kernel F per octave),
called stage by stage through ``models/sift.py``'s stage functions, with
the JAX script's rows in its order: the ``alt`` rows (the front route's
kernel A and plain stacks, kernel E's gauss twin rows, the r3 dedup,
kernel C's pyramids, the detect sub-stages), then the matcher (kernel B
against its plain version, on the B/2 pairs at ``ori_cap`` lanes) and one
blur (kernel D against its plain version, 960 x 1280 at sigma 1.6, single
and batch B), each beside its library call (``torch.cdist`` + ``topk``;
replicate padding + a 1-D ``conv2d`` per axis), as ``PERF.md``'s kernel
table uses them.  Rows starting with ``alt``, ``match`` or ``blur`` stay
out of the stage total.  Frames: the CAVE-01 pair x B/2 (the oracle's
decoded pixels, tests/data/oracle_cave0{0,1}.npz), float32, 640 x 480
doubled; capacities ``SiftConfig()``'s (8192 / 4096 / 8192) or, with
``--bench-caps``, the bench's (6144 / 1536 / 2048).

Each row: one call's median and min over ``--reps`` rounds of 8 calls
closed by a wait for the card (``utils/profiling.time_calls``), stage by
stage, so the sum overstates a free-running sweep.  One JSON line per row
(``row``, ``jax_row``: the JAX script's name of the same row, null for
the library rows); then the kernels' launches over the run, a check
(after timing) that the stage chain's final keypoints are bit-equal to
``detect_and_describe_batch`` on the same batch (a difference exits 1),
and as the last line ``{"stage_total_ms_median": ..., "batch": B}``.
``--out FILE`` writes the markdown table, headed by the card's name and
power limit as nvidia-smi reports them.

    python scripts/torch_perf_breakdown.py [--batch 8] [--reps 30] [--out FILE]
        [--bench-caps] [--device cpu]

Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from sift_tpu_torch import SiftConfig  # noqa: E402
from sift_tpu_torch.config import gaussian_half_kernel  # noqa: E402
from sift_tpu_torch.models import sift as S  # noqa: E402
from sift_tpu_torch.models.detect import detect_extrema_all, refine_keypoints_all  # noqa: E402
from sift_tpu_torch.models.match import match_descriptors, ratio_accept  # noqa: E402
from sift_tpu_torch.ops.blur import separable_blur  # noqa: E402
from sift_tpu_torch.ops.blur_pass import separable_blur_kernel  # noqa: E402
from sift_tpu_torch.ops.gather import StackSpace  # noqa: E402
from sift_tpu_torch.ops.top2 import top2_plain  # noqa: E402
from sift_tpu_torch.parallel.multihost import kernel_wrappers  # noqa: E402
from sift_tpu_torch.utils import keypoints as kputil  # noqa: E402
from sift_tpu_torch.utils.keypoints import FIELDS  # noqa: E402
from sift_tpu_torch.utils.numerics import resolve_device  # noqa: E402
from sift_tpu_torch.utils.profiling import time_calls  # noqa: E402

EXCLUDED = ("match ", "blur ", "alt ")  # not stages of the pipeline's total
# scripts/perf_breakdown.py's rows on its front route, in its order ({B}: the batch)
JAX_ROWS = (
    "front-twin (pyramids+mask+twin rows)", "detect+refine (counts, twin DoG)",
    "alt front r3 (plain stacks)", "alt detect+refine r3 (relayouts DoG)",
    "alt gauss MultiRows relayout r3", "orientation (all octaves)",
    "dedup (sort+unique) + compact", "alt dedup r3 (lexsort+gathers)",
    "descriptors (all octaves)", "alt pyramids (fused octave kernel)",
    "alt detect: extrema+compact only", "alt detect: refine only",
    "match XLA (B/2 pairs, 8192^2)", "match Pallas (B/2 pairs, 8192^2)",
    "blur XLA (960x1280, s=1.6)", "blur Pallas (960x1280, s=1.6)",
    "blur XLA batch {B}", "blur Pallas batch {B}",
)


def jax_rows(batch: int) -> list[str]:
    return [r.replace("{B}", str(batch)) for r in JAX_ROWS]


def frames(batch: int) -> np.ndarray:
    """The CAVE-01 pair x batch/2 as the oracle decoded it, (B, H, W, 3)
    uint8 (``chip_smoke.py``'s batch)."""
    pair = [np.load(os.path.join(ROOT, "tests", "data", f"oracle_cave0{i}.npz"))["input"]
            for i in (0, 1)]
    return np.stack(pair * (batch // 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=None)
    ap.add_argument("--bench-caps", action="store_true",
                    help="the bench's capacities (6144/1536/2048) instead of SiftConfig()'s")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    cfg = SiftConfig(**C.CAPS) if args.bench_caps else SiftConfig()
    B = args.batch
    imgs = S.as_batch(frames(B), cfg, dev)
    h, w = imgs.shape[1], imgs.shape[2]
    octaves = S.octaves_for(imgs, cfg)
    smi = C.smi_line() if cuda else "cpu"
    counted = kernel_wrappers()
    for fn in counted.values():
        fn.launches = 0

    rows = []  # (row, jax_row, median_ms, min_ms)

    def add(name, fn, jax_row=None, library=False):
        med, mn, out = time_calls(fn, args.reps)
        row = dict(row=name, jax_row=None if library else (jax_row or name),
                   median_ms=med * 1e3, min_ms=mn * 1e3)
        rows.append(row)
        print(json.dumps(row), flush=True)
        return out

    # --- stage by stage: the front-twin route (detect_and_describe_batch) ---
    gsp, dsp, masks, fcounts = add("front-twin (pyramids+mask+twin rows)",
                                   lambda: S.front_twin(imgs, cfg, octaves=octaves))
    kp0, _ = add("detect+refine (counts, twin DoG)",
                 lambda: S.detect_refine(dsp, masks, fcounts, cfg))
    del dsp, masks, fcounts
    # the front route (kernel A, plain stacks) for comparison: "alt" rows
    gaussians, dogs, masks3, fcounts3 = add("alt front r3 (plain stacks)",
                                            lambda: S.front(imgs, cfg, octaves))
    add("alt detect+refine r3 (relayouts DoG)",
        lambda: S.detect_refine(StackSpace.build(dogs), masks3, fcounts3, cfg))
    del masks3, fcounts3
    add("alt gauss MultiRows relayout r3", lambda: S.gather_space(gaussians, twin_rows=True))
    del gaussians
    cand, _ = add("orientation (all octaves)", lambda: S.orient(gsp, kp0, cfg))
    allkp = add("dedup (sort+unique) + compact", lambda: S.dedup(cand, cfg))
    add("alt dedup r3 (lexsort+gathers)",
        lambda: kputil.compact(kputil.sort_and_dedup(cand), cfg.ori_cap))
    kp = add("descriptors (all octaves)", lambda: S.describe(gsp, allkp, cfg))
    del gsp

    cfg_c = dataclasses.replace(cfg, use_octave_kernel=True)
    add("alt pyramids (fused octave kernel)", lambda: S.pyramids(imgs, cfg_c, octaves))

    # --- detect + refine sub-stages, on the front route's plain DoG stacks ---
    oct_id, zyx, valid, _tot = add(
        "alt detect: extrema+compact only",
        lambda: detect_extrema_all(dogs, cfg.extremum_threshold(), cfg.extrema_cap,
                                   cfg.window_size))
    add("alt detect: refine only",
        lambda: refine_keypoints_all(StackSpace.build(dogs), oct_id, zyx, valid, cfg))
    del dogs

    # --- matcher: kernel B against its plain version at ori_cap lanes ---
    d1, v1 = kp.desc[0::2].contiguous(), kp.valid[0::2].contiguous()
    d2, v2 = kp.desc[1::2].contiguous(), kp.valid[1::2].contiguous()
    lanes = f"B/2 pairs, {cfg.ori_cap}^2"

    def match_plain():
        best, second, idx = top2_plain(d1, d2, v2)
        return idx, ratio_accept(best, second, v1, cfg.ratio_threshold), best, second

    add(f"match plain ({lanes})", match_plain, jax_row="match XLA (B/2 pairs, 8192^2)")
    add(f"match kernel B ({lanes})",
        lambda: match_descriptors(d1, v1, d2, v2, cfg.ratio_threshold, device=dev),
        jax_row="match Pallas (B/2 pairs, 8192^2)")
    f1, f2 = d1.float(), d2.float()
    add(f"match library cdist+topk ({lanes})",
        lambda: torch.cdist(f1, f2).topk(2, dim=-1, largest=False), library=True)
    del f1, f2

    # --- blur: kernel D against its plain version (one 2-D blur) ---
    base = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 255, (960, 1280)).astype(np.float32)).to(dev)
    hk = gaussian_half_kernel(1.6)
    bbase = base.expand(B, 960, 1280).contiguous()
    for what, x, jax_what in (("(960x1280, s=1.6)", base[None], "(960x1280, s=1.6)"),
                              (f"batch {B}", bbase, f"batch {B}")):
        add(f"blur plain {what}", lambda x=x: separable_blur(x, hk),
            jax_row=f"blur XLA {jax_what}")
        add(f"blur kernel D {what}", lambda x=x: separable_blur_kernel(x, hk),
            jax_row=f"blur Pallas {jax_what}")
        add(f"blur library conv2d {what}", lambda x=x: C.library_blur(x, hk), library=True)
    del base, bbase

    launches = {k: fn.launches for k, fn in counted.items()}

    # --- the stage chain's keypoints against the entry point, once ---
    ref = S.detect_and_describe_batch(imgs, cfg, device=dev)
    equal = all(torch.equal(getattr(kp, f), getattr(ref, f)) for f in FIELDS)

    stage_rows = [r for r in rows if not r["row"].startswith(EXCLUDED)]
    total = sum(r["median_ms"] for r in stage_rows)
    print(json.dumps(dict(launches=launches, route=S.route_of(cfg, dev),
                          chain_equal_entry_point=equal, keypoints=kp.valid.sum(-1).tolist(),
                          capacities=[cfg.extrema_cap, cfg.kp_cap, cfg.ori_cap],
                          octaves=octaves, size=[h, w], nvidia_smi=smi,
                          frames_per_s_equiv=B / (total / 1e3))), flush=True)

    if args.out:
        lines = [
            f"# PERF — per-stage breakdown ({smi})",
            "",
            f"Batched pipeline, B={B} frames of {w}x{h} (CAVE-01 pair x{B // 2}), "
            f"{octaves} octaves, capacities extrema/kp/ori = "
            f"{cfg.extrema_cap}/{cfg.kp_cap}/{cfg.ori_cap}, float32, route "
            f"{S.route_of(cfg, dev)}.",
            f"reps={args.reps}; one call's time, 8 calls a round closed by a wait for the "
            "device (stage-synchronous, so the sum overstates a free-running sweep).",
            "",
            "| stage | median ms | min ms | % of stage total |",
            "|---|---|---|---|",
        ]
        for r in rows:
            pct = "—" if r["row"].startswith(EXCLUDED) else f"{100 * r['median_ms'] / total:.1f}%"
            lines.append(f"| {r['row']} | {r['median_ms']:.3f} | {r['min_ms']:.3f} | {pct} |")
        lines.append("")
        with open(args.out, "w") as f:
            f.write("\n".join(lines))
        print(json.dumps(dict(wrote=args.out)), flush=True)

    print(json.dumps({"stage_total_ms_median": total, "batch": B}), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
