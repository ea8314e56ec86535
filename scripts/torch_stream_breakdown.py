"""Where a streamed sweep of ``python -m sift_tpu_torch.bench`` spends its
time, seen from the main thread, on the card.

    python scripts/torch_stream_breakdown.py [--batch 16] [--sweeps 6]

The bench's stream (the 35 CAVE-01 frames as PNG, ``STREAM_CAPS``):

* per decoder thread count (8, 4, 2; two repeats each): ms a sweep in
  all, of which the main thread spends in ``stage_batches`` (waiting for
  the loader's frames, copying them out, converting them to uint8 into a
  pinned buffer, the non-blocking copy) and in the sweep itself;
* the loader alone at 8, 4, 2 and 1 threads, frames/s;
* the same sweeps from batches already on the card, alone and beside a
  loader that keeps 8, 4 or 2 threads decoding (the host's cores shared
  with the host-paced entry point);
* the uint8 conversion of one batch into a pinned buffer alone.

Prints one JSON line with the card's name and power limit.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--sweeps", type=int, default=6)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sift_tpu_torch import SiftConfig
    from sift_tpu_torch import bench as BN
    from sift_tpu_torch.utils.native import ImageLoader

    if not torch.cuda.is_available():
        print("torch_stream_breakdown: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = SiftConfig(**BN.STREAM_CAPS)
    frames = BN.scene_frames()
    b, k = args.batch, args.sweeps
    order = [(s * b + i) % len(frames) for s in range(k) for i in range(b)]
    on_device = [t for t, _ in BN.stage_batches([frames[i] for i in order], b, dev)]

    def in_memory_ms() -> float:
        t = time.perf_counter()
        for imgs in on_device:
            BN.sweep(imgs, cfg, dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / k * 1e3

    out = dict(batch=b, sweeps=k, caps=BN.STREAM_CAPS)
    with tempfile.TemporaryDirectory() as tmp:
        paths = BN.write_pngs(frames, tmp)
        seq = [paths[i] for i in order]
        BN.stream_sweeps(paths, cfg, b, 1, BN.STREAM_THREADS, dev)
        torch.cuda.synchronize()
        streamed = {}
        for threads in (8, 4, 2):
            runs = []
            for _ in range(2):
                stage = sweep = 0.0
                t_all = time.perf_counter()
                with ImageLoader(seq, threads) as loader:
                    batches = BN.stage_batches(loader, b, dev)
                    for _ in range(k):
                        t = time.perf_counter()
                        imgs, _ = next(batches)
                        stage += time.perf_counter() - t
                        t = time.perf_counter()
                        BN.sweep(imgs, cfg, dev)
                        sweep += time.perf_counter() - t
                torch.cuda.synchronize()
                runs.append(dict(total_ms=(time.perf_counter() - t_all) / k * 1e3,
                                 stage_ms=stage / k * 1e3, sweep_ms=sweep / k * 1e3))
            streamed[threads] = runs
        out["streamed_sweep"] = streamed

        decode = {}
        for threads in (8, 4, 2, 1):
            t = time.perf_counter()
            with ImageLoader(seq, threads) as loader:
                n = sum(1 for _ in loader)
            decode[threads] = n / (time.perf_counter() - t)
        out["decode_fps"] = decode

        in_memory_ms()
        alone = [in_memory_ms() for _ in range(2)]
        beside = {}
        for threads in (8, 4, 2):
            stop = threading.Event()

            def drain(threads=threads):
                while not stop.is_set():
                    with ImageLoader(paths * 3, threads) as loader:
                        for _ in loader:
                            if stop.is_set():
                                break

            th = threading.Thread(target=drain)
            th.start()
            try:
                time.sleep(0.2)
                beside[threads] = in_memory_ms()
            finally:
                stop.set()
                th.join(timeout=120)
        out["in_memory_sweep_ms"] = dict(alone=alone, beside_decoding_threads=beside)

    f32 = [f.astype(np.float32) for f in frames[:b]]
    buf = torch.empty((b,) + frames[0].shape, dtype=torch.uint8, pin_memory=True).numpy()
    t = time.perf_counter()
    for _ in range(10):
        for i, f in enumerate(f32):
            np.copyto(buf[i], f, casting="unsafe")
    out["uint8_into_pinned_ms"] = (time.perf_counter() - t) / 10 * 1e3
    out["cpu_count"] = os.cpu_count()
    out["median_streamed_total_ms"] = {t: statistics.median(r["total_ms"] for r in runs)
                                       for t, runs in streamed.items()}
    out["device"] = BN.device_line(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
