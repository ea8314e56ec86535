"""End-to-end scene throughput of the port on the card: the threaded
native decoder, uint8 batches onto the card, batched detection, and
matching of consecutive frames (the counterpart of
``scripts/scene_throughput.py``).

    python scripts/torch_scene_throughput.py <scene_dir> [--batch 8] [--threads 4]

``ImageLoader`` decodes the scene's ``*.jpg`` and ``*.png`` files (sorted
by name) on host threads while the card runs the batches
(``sift_tpu_torch.bench.scene_matches``: two pinned host buffers, the last
batch padded, the default ``SiftConfig``, 4 pairs a matcher call).  One
warm-up batch runs first, outside the timed window.  Prints one JSON line:
frames, pairs, seconds and frames/s including I/O, the median match count
of a pair, and the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene_dir")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sift_tpu_torch import SiftConfig
    from sift_tpu_torch.bench import device_line, scene_matches, stage_batches, sweep
    from sift_tpu_torch.utils.native import ImageLoader

    if not torch.cuda.is_available():
        print("torch_scene_throughput: no CUDA device", file=sys.stderr)
        return 2
    paths = sorted(glob.glob(os.path.join(args.scene_dir, "*.jpg"))
                   + glob.glob(os.path.join(args.scene_dir, "*.png")))
    if len(paths) < 2:
        print(f"torch_scene_throughput: fewer than two jpg / png files in {args.scene_dir}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = SiftConfig()

    # Warm-up on one batch of the first frame, outside the timed window.
    with ImageLoader(paths[:1], 1) as loader:
        first = next(loader)
    for imgs, _ in stage_batches([first] * args.batch, args.batch, dev):
        sweep(imgs, cfg, dev)
    torch.cuda.synchronize()

    t = time.perf_counter()
    kp, (_, accept) = scene_matches(paths, cfg, args.batch, args.threads, dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t

    counts = accept.sum(1).cpu().numpy()
    print(json.dumps(dict(
        scene=os.path.basename(os.path.normpath(args.scene_dir)),
        frames=int(kp.valid.shape[0]), pairs_matched=int(len(counts)),
        seconds_incl_io=seconds, frames_per_s_incl_io=kp.valid.shape[0] / seconds,
        median_pair_matches=int(np.median(counts)), batch=args.batch, threads=args.threads,
        device=device_line(dev))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
