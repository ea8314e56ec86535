"""The readings that set each cell's limits (not part of a run).

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 [--seconds 8] [--program tf32]

For each of ``--seeds`` it runs the cell with the plain reference in the
program's place, computed as ``--program`` says
(``reference/sift_plain.describe``'s ``variant``): ``tf32``, the control,
the nearest precision below the configuration's float32 (the upper
readings); ``reordered``, a sound float32 program whose sums run in
another order (beside the program's own runs, the lower readings).  Its
keypoints are packed into lane buffers of the configuration's capacity and
its matches come from the plain matcher; it is judged against the
reference as a run judges the program, through ``harness.run_cell`` with
a short window: same requests, same samples, same judge.  Prints one JSON
line per seed: the numbers compared.  Needs the card, as
``benchmark.run`` does.
"""

from __future__ import annotations

import argparse
import json
import sys
import types

import torch

from benchmark import harness, judge


class ReferenceProgram:
    """(detect, match) with the entry points' contracts, computed by the
    plain reference as ``variant``."""

    def __init__(self, cell: harness.Cell, dev, variant: str):
        self.cap = cell.config["sift"]["ori_cap"]
        self.params = cell.config["sift"]
        self.dev, self.variant = dev, variant

    def detect(self, images, cfg, return_counts=True, device=None):
        from benchmark.reference import sift_plain

        imgs = torch.as_tensor(images).to(self.dev)
        lanes = {k: [] for k in judge.FIELDS + ("desc", "valid")}
        n_ext, n_ref, n_ori = [], [], []
        for img in imgs:
            kp = sift_plain.describe(img, self.params, self.variant)
            n = len(kp["x"])
            for k in judge.FIELDS + ("desc",):
                pad = torch.zeros((self.cap - n,) + kp[k].shape[1:], dtype=kp[k].dtype,
                                  device=self.dev)
                lanes[k].append(torch.cat([kp[k], pad]))
            lanes["valid"].append(torch.arange(self.cap, device=self.dev) < n)
            for lst, c in ((n_ext, "extrema"), (n_ref, "refined"), (n_ori, "oriented")):
                lst.append(kp["counts"][c])
        out = types.SimpleNamespace(**{k: torch.stack(v) for k, v in lanes.items()})
        counts = dict(extrema=torch.tensor(n_ext), refined=torch.tensor(n_ref),
                      oriented=torch.tensor(n_ori),
                      refine_active=torch.zeros((len(imgs), 2), dtype=torch.int64),
                      ori_slots_max=torch.tensor(0))
        return (out, counts) if return_counts else out

    def match(self, d1, v1, d2, v2, ratio, device=None):
        from benchmark.reference import match_plain

        idx = torch.zeros(v1.shape, dtype=torch.int64)
        acc = torch.zeros(v1.shape, dtype=torch.bool)
        best = torch.full(v1.shape, match_plain.HUGE, dtype=torch.int64)
        for p in range(len(d1)):
            r1, r2 = v1[p].nonzero()[:, 0], v2[p].nonzero()[:, 0]
            i, a, d = match_plain.ratio_matches(d1[p][r1], d2[p][r2], ratio)
            idx[p, r1.cpu()] = r2[i].cpu() if len(r2) else 0
            acc[p, r1.cpu()] = a.cpu()
            best[p, r1.cpu()] = d.cpu()
        return idx, acc, best, None


def readings(name: str, seed: int, seconds: float, device, hooks=None,
             variant: str = "tf32") -> dict:
    """The numbers of one run of cell ``name`` with the reference, computed
    as ``variant``, in the program's place."""
    hooks = dict(hooks or {})
    prog = ReferenceProgram(harness.Cell(name, hooks.get("root", harness.ROOT)),
                            torch.device(device), variant)
    hooks["program"] = (prog.detect, prog.match)
    result, _ = harness.run_cell(name, seed, seconds, False, device, hooks=hooks)
    return dict(workload=name, program=variant, seed=seed, correct=result["correct"],
                attempted=result["attempted"], failed=result["failed"],
                numbers={k: v["value"] for k, v in result["checks"].items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--program", choices=("tf32", "reordered"), default="tf32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, "cuda",
                                  variant=args.program)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
