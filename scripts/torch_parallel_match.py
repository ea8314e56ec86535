#!/usr/bin/env python3
"""The CAVE 00 / 01 pair through the port's multi-device layer, one rank
per process:

    torchrun --nproc_per_node=N scripts/torch_parallel_match.py [--device cpu]

Every rank joins the group from torchrun's environment
(``parallel.multihost.initialize``: NCCL on cards, one rank per card; gloo
with ``--device cpu``), builds a (1, N) mesh, detects both frames
(``batched_detect``, replicated over the kp axis) and matches them with the
B side sharded over N ranks (``sharded_match``; N must divide the 2048
descriptor lanes).  Rank 0 prints one JSON line: the keypoints (677 / 1067)
and the matches (165) of the reference.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sift_tpu_torch import SiftConfig  # noqa: E402
from sift_tpu_torch.parallel import batched_detect, make_mesh, sharded_match  # noqa: E402
from sift_tpu_torch.parallel.multihost import fleet_barrier, initialize  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    initialize(backend="gloo" if args.device == "cpu" else None)
    if not dist.is_initialized():
        print("run through torchrun (MASTER_ADDR, WORLD_SIZE, RANK)", file=sys.stderr)
        return 2
    try:
        world = fleet_barrier()
        cfg = SiftConfig(extrema_cap=6144, kp_cap=1536, ori_cap=2048)
        frames = np.stack([np.load(ROOT / f"tests/data/oracle_cave0{i}.npz")["input"]
                           for i in (0, 1)])
        mesh = make_mesh(1, world, device=args.device)
        octaves = cfg.octaves_count(frames.shape[2] * 2, frames.shape[1] * 2)
        kp = batched_detect(frames, cfg, octaves, mesh)
        _, accept, _, _ = sharded_match(kp.desc[0], kp.valid[0], kp.desc[1], kp.valid[1], mesh)
        if dist.get_rank() == 0:
            print(json.dumps(dict(ranks=world, backend=dist.get_backend(),
                                  keypoints=kp.valid.sum(1).tolist(),
                                  matches=int(accept.sum()))), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
