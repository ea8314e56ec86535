"""The readings that set the panorama cells' limits (not part of a run).

    python3 -m benchmark.control_panorama --workload <cell> --seeds 1 2 3 [--seconds 8] \
        [--program tf32|reordered] [--frozen-keypoints]

For each of ``--seeds`` it runs the cell with the plain reference in the
program's place, as ``benchmark/control.py`` does for the detection
cells: the keypoints of ``reference/sift_plain`` packed into lane
buffers, the plain matcher, and the stitching of
``reference/stitch_plain``, all computed as ``--program`` says (``tf32``,
the control, the nearest precision below the configuration's float32:
the upper readings; ``reordered``, a sound float32 program: beside the
program's own runs, the lower readings); with ``--frozen-keypoints`` the
detection is the frozen reference's and only the stitching is the
variant's.  It is judged against the frozen
reference as a run judges the program, through ``harness.run_cell`` with
a short window.  Prints one JSON line per seed: the numbers compared.
Needs the card, as ``benchmark.run`` does.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import control, harness
from benchmark.reference import stitch_plain


class PlainStitch:
    """``stitch(images, kps)`` -> (edge homographies, canvas) by
    ``stitch_plain`` as ``variant``, on the lanes' valid keypoints."""

    def __init__(self, cell: harness.Cell, dev, variant: str):
        self.params, self.dev, self.variant = cell.config["stitch"], dev, variant
        self.lanes = cell.config["sift"]["ori_cap"]
        self.ratio = cell.config["sift"]["ratio_threshold"]

    def __call__(self, images, kps):
        plain = [dict(x=kp.x[kp.valid], y=kp.y[kp.valid], desc=kp.desc[kp.valid]) for kp in kps]
        return stitch_plain.stitch(images, plain, self.params, self.lanes, self.ratio, self.dev,
                                   self.variant)


def readings(name: str, seed: int, seconds: float, device, hooks=None,
             variant: str = "tf32", frozen_keypoints: bool = False) -> dict:
    """The numbers of one run of cell ``name`` with the reference in the
    program's place, computed as ``variant`` (its detection frozen with
    ``frozen_keypoints``)."""
    hooks = dict(hooks or {})
    cell = harness.Cell(name, hooks.get("root", harness.ROOT))
    dev = torch.device(device)
    detect = "frozen" if frozen_keypoints else variant
    prog = control.ReferenceProgram(cell, dev, detect)
    hooks["program"] = (prog.detect, prog.match, PlainStitch(cell, dev, variant))
    result, _ = harness.run_cell(name, seed, seconds, False, device, hooks=hooks)
    return dict(workload=name, program=variant, detect=detect, seed=seed,
                correct=result["correct"], attempted=result["attempted"],
                failed=result["failed"],
                numbers={k: v["value"] for k, v in result["checks"].items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control_panorama")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--program", choices=("tf32", "reordered"), default="tf32")
    ap.add_argument("--frozen-keypoints", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control_panorama: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, "cuda", variant=args.program,
                                  frozen_keypoints=args.frozen_keypoints)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
