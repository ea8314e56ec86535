"""Throughput of the port on the card: ``python -m sift_tpu_torch.bench``.

The counterpart of the repo's ``bench.py``: SIFT detect + describe + match
at 640x480 in frames/s, two numbers, printed as one JSON line.

* Device-resident (``resident``): the CAVE-01 pair
  (``tests/data/oracle_cave0{0,1}.npz``, ``input``) x batch/2 as one
  float32 batch on the card, capacities ``PAIR_CAPS``; every true count
  checked against its capacity (``check_counts``); ``sweeps`` sweeps (the
  entry point, then the matcher on the pairs (0, 1), (2, 3), ...), one
  ``torch.cuda.synchronize``, ``repeats`` times; the median and the best.
  The entry point reads the host inside its stages (the per-class lane
  counts of orientation and descriptors and their valid lanes), so the
  sweeps do not queue up ahead of the card as they do on the TPU: the
  number holds each sweep's host time.
* Streaming (``streaming``): the 35 CAVE-01 frames of
  ``tests/data/scene_oracle``, written once as PNG to a temporary
  directory outside the timed window, decoded by ``ImageLoader``,
  converted to uint8 into one of two pinned host buffers, copied to the
  card without blocking (``stage_batches``), then the entry point and the
  matcher at ``STREAM_CAPS``, which the honesty scan first checks on all
  35 frames.  Beside it, in turns, the same sweeps from uint8 batches
  already on the card (``stream_in_memory_fps``: the stream's cost without
  the host's decoding and staging), and the pinned host-to-card copy's
  own ceiling.

On the card unless ``--device cpu`` is given; without a card it exits 2.
A failed stream step or a clipped count ends the run with an error: no
result is printed for it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.models.match import match_descriptors
from sift_tpu_torch.models.sift import as_batch, clipped, detect_and_describe_batch
from sift_tpu_torch.utils import keypoints as kputil
from sift_tpu_torch.utils.io import save_image
from sift_tpu_torch.utils.native import ImageLoader
from sift_tpu_torch.utils.numerics import resolve_device

DATA = Path(__file__).resolve().parents[1] / "tests" / "data"
METRIC = "sift_detect_describe_match_640x480"
# The C++ reference on one CPU core: 2 frames / (77.6 + 114.8 + 0.0614) s
# (BASELINE.md), as the repo's bench.py divides by it.
BASELINE_FPS = 2.0 / (77.6 + 114.8 + 0.0614)
# The pair's capacities, bench.py's: its measured content plus headroom.
PAIR_CAPS = dict(extrema_cap=6144, kp_cap=1536, ori_cap=2048)
# The scene's: bench.py streams at 8192 / 2048 / 3072, where frame 12's
# Newton cascade clips (phase caps 2048 and 1024); 12288 extrema give
# phase caps 3072 and 1536, and the scan below holds all 35 frames to them.
STREAM_CAPS = dict(extrema_cap=12288, kp_cap=2048, ori_cap=3072)
SCENE_FRAMES = 35
PAIR_CHUNK = 4  # consecutive pairs a matcher call in ``scene_matches``
STREAM_THREADS = 8  # the stream's decoder threads, bench.py's


class CapacityError(RuntimeError):
    """A true count above its capacity: real detections were clipped."""


def _host(counts: dict) -> dict[str, np.ndarray]:
    return {k: np.asarray(torch.as_tensor(v).cpu()) for k, v in counts.items()}


def check_counts(counts: dict, cfg: SiftConfig, what: str, frames: int | None = None,
                 first: int = 0) -> None:
    """Raise ``CapacityError`` naming every clipped count
    (``models.sift.clipped``)."""
    bad = clipped(counts, cfg, frames, first)
    if bad:
        raise CapacityError(f"{what}: " + "; ".join(
            f"frame {c['frame']}: {c['count']} {c['value']} > cap {c['cap']}" for c in bad))


def pair_frames(batch: int) -> np.ndarray:
    """The CAVE-01 pair x batch/2, (batch, 480, 640, 3) uint8."""
    pair = [np.load(DATA / f"oracle_cave0{i}.npz")["input"] for i in (0, 1)]
    return np.stack(pair * (batch // 2))


def scene_frames() -> list[np.ndarray]:
    """The 35 CAVE-01 scene frames, (480, 640, 3) uint8 each."""
    return [np.load(DATA / "scene_oracle" / f"cave01_{i:02d}.npz")["input"]
            for i in range(SCENE_FRAMES)]


def write_pngs(frames, directory) -> list[str]:
    """``frames`` as ``directory/00.png``, ``01.png``, ...; their paths."""
    paths = [str(Path(directory) / f"{i:02d}.png") for i in range(len(frames))]
    for p, f in zip(paths, frames):
        save_image(p, f)
    return paths


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stage_batches(frames, batch: int, device="cuda"):
    """Group ``frames`` ((H, W, C) arrays of integers in [0, 255], such as
    an ``ImageLoader``'s) into uint8 batches on ``device``; yields
    (tensor (batch, H, W, C), number of frames of ``frames`` in it).  A
    short last batch is filled up with copies of its last frame.

    On the card each batch is converted into one of two pinned host
    buffers and copied without blocking, so decoding and conversion of the
    next batch overlap the card's work on this one.  Before a buffer is
    refilled, the event recorded after its last copy is waited on: a copy
    in flight never reads a frame being written.  On the CPU each batch is
    a tensor of its own.
    """
    dev = resolve_device(device)
    it = iter(frames)
    bufs: list[torch.Tensor | None] = [None, None]
    copied: list[torch.cuda.Event | None] = [None, None]
    for k in itertools.count():
        chunk = list(itertools.islice(it, batch))
        if not chunk:
            return
        n = len(chunk)
        chunk += [chunk[-1]] * (batch - n)
        shape = (batch,) + tuple(chunk[0].shape)
        slot = k % 2
        if copied[slot] is not None:
            copied[slot].synchronize()
        if bufs[slot] is None or tuple(bufs[slot].shape) != shape:
            bufs[slot] = torch.empty(shape, dtype=torch.uint8, pin_memory=dev.type == "cuda")
        host = bufs[slot].numpy()
        for i, f in enumerate(chunk):
            if f.shape != shape[1:]:
                raise ValueError(f"frame of shape {f.shape} in a batch of {shape[1:]}")
            np.copyto(host[i], f, casting="unsafe")
        if dev.type == "cpu":
            yield bufs[slot].clone(), n
            continue
        out = bufs[slot].to(dev, non_blocking=True)
        copied[slot] = torch.cuda.Event()
        copied[slot].record()
        yield out, n


def scene_matches(paths, cfg: SiftConfig, batch: int = 8, threads: int = 4, device="cuda"):
    """A scene from disk to matches (the repo's ``scripts/scene_throughput.py``
    loop): ``ImageLoader``, uint8 batches onto the device (the last one
    padded), the entry point, then each consecutive pair (i, i + 1) matched,
    ``PAIR_CHUNK`` pairs a matcher call.  Returns the frames' Keypoints
    (leading dim one per frame) and (best_idx, accept) per pair."""
    dev = resolve_device(device)
    kps = []
    with ImageLoader(paths, threads) as loader:
        for imgs, n in stage_batches(loader, batch, dev):
            kp = detect_and_describe_batch(imgs, cfg, device=dev)
            kps.append(kp.map(lambda a, n=n: a[:n]))
    kp = kputil.Keypoints(**{f: torch.cat([getattr(k, f) for k in kps]) for f in kputil.FIELDS})
    n_pairs = kp.valid.shape[0] - 1
    if n_pairs < 1:
        raise ValueError(f"a scene needs at least two frames, got {n_pairs + 1}")
    idx, acc = [], []
    for s in range(0, n_pairs, PAIR_CHUNK):
        a = torch.arange(s, min(s + PAIR_CHUNK, n_pairs), device=dev)
        m = match_descriptors(kp.desc[a], kp.valid[a], kp.desc[a + 1], kp.valid[a + 1],
                              cfg.ratio_threshold, device=dev)
        idx.append(m[0])
        acc.append(m[1])
    return kp, (torch.cat(idx), torch.cat(acc))


def sweep(imgs, cfg: SiftConfig, device):
    """One sweep: the entry point on a batch, then the matcher on its pairs
    (0, 1), (2, 3), ...; returns the pairs' accept masks."""
    kp = detect_and_describe_batch(imgs, cfg, device=device)
    return match_descriptors(kp.desc[0::2], kp.valid[0::2], kp.desc[1::2], kp.valid[1::2],
                             cfg.ratio_threshold, device=device)[1]


def stream_sweeps(paths, cfg: SiftConfig, batch: int, sweeps: int,
                  threads: int = STREAM_THREADS, device="cuda"):
    """``sweeps`` sweeps of ``batch`` frames each, cycling over ``paths``,
    from disk: ``ImageLoader`` -> ``stage_batches`` -> ``sweep``.  Returns
    the last sweep's accept masks (not waited on)."""
    dev = resolve_device(device)
    seq = [paths[(s * batch + i) % len(paths)] for s in range(sweeps) for i in range(batch)]
    out = None
    with ImageLoader(seq, threads) as loader:
        for imgs, _ in stage_batches(loader, batch, dev):
            out = sweep(imgs, cfg, dev)
    return out


def honesty_scan(paths, cfg: SiftConfig, batch: int, threads: int = STREAM_THREADS,
                 device="cuda") -> dict:
    """Every frame of ``paths`` within ``cfg``'s capacities (``check_counts``),
    through the loader in batches (the last padded).  Returns the largest
    count of any frame: extrema, refined, oriented, each Newton phase's
    active lanes (``refine_active``, a list) and ``ori_slots_max``."""
    dev = resolve_device(device)
    most: dict = {}
    with ImageLoader(paths, threads) as loader:
        for k, (imgs, n) in enumerate(stage_batches(loader, batch, dev)):
            _, counts = detect_and_describe_batch(imgs, cfg, return_counts=True, device=dev)
            check_counts(counts, cfg, "stream", n, k * batch)
            for name, v in _host(counts).items():
                m = v[:n].max(0) if v.ndim else v
                most[name] = np.maximum(most.get(name, m), m)
    return {k: v.tolist() for k, v in most.items()}


def _timed(fn, dev, repeats: int, per: int) -> list[float]:
    """Seconds per unit of ``fn`` (which does ``per`` units), ``repeats``
    times, each ended by a synchronise."""
    out = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t) / per)
    return out


def resident(batch: int, sweeps: int, repeats: int, device="cuda") -> dict:
    """The device-resident number: frames/s, median and best."""
    dev = resolve_device(device)
    cfg = SiftConfig(**PAIR_CAPS)
    imgs = as_batch(pair_frames(batch), cfg, dev)
    sweep(imgs, cfg, dev)
    _sync(dev)
    _, counts = detect_and_describe_batch(imgs, cfg, return_counts=True, device=dev)
    check_counts(counts, cfg, "pair batch")
    per = _timed(lambda: [sweep(imgs, cfg, dev) for _ in range(sweeps)], dev, repeats, sweeps)
    return dict(value=batch / statistics.median(per), best=batch / min(per),
                sweep_ms=[s * 1e3 for s in per])


def h2d_ceiling(shape, device="cuda") -> float | None:
    """Seconds per pinned uint8 host-to-card copy of ``shape`` (four
    buffers a round, median of three rounds); None off the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    rng = np.random.default_rng(1)
    host = [torch.from_numpy(rng.integers(0, 255, shape, dtype=np.uint8)).pin_memory()
            for _ in range(4)]
    dst = [torch.empty(shape, dtype=torch.uint8, device=dev) for _ in host]
    dst[0].copy_(host[0], non_blocking=True)
    _sync(dev)

    def copies():
        for d, h in zip(dst, host):
            d.copy_(h, non_blocking=True)
    return statistics.median(_timed(copies, dev, 3, len(host)))


def streaming(batch: int, sweeps: int, repeats: int, device="cuda") -> dict:
    """The streaming number, its capacities and largest counts, the same
    sweeps from uint8 batches already on the device (in turns with the
    stream: what the host's I/O adds), and the copy ceiling."""
    dev = resolve_device(device)
    cfg = SiftConfig(**STREAM_CAPS)
    frames = scene_frames()
    seq = [frames[(s * batch + i) % len(frames)] for s in range(sweeps) for i in range(batch)]
    on_device = [b for b, _ in stage_batches(seq, batch, dev)]
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_pngs(frames, tmp)
        most = honesty_scan(paths, cfg, batch, STREAM_THREADS, dev)
        stream_sweeps(paths, cfg, batch, 1, STREAM_THREADS, dev)
        _sync(dev)
        per, mem = [], []
        for _ in range(repeats):
            per += _timed(lambda: stream_sweeps(paths, cfg, batch, sweeps, STREAM_THREADS, dev),
                          dev, 1, sweeps)
            mem += _timed(lambda: [sweep(b, cfg, dev) for b in on_device], dev, 1, sweeps)
    out = dict(stream_fps=batch / statistics.median(per),
               stream_method=f"PNG decode (ImageLoader, {STREAM_THREADS} threads), uint8 "
                             f"into two pinned host buffers, non-blocking copy to the "
                             f"device, entry point and matcher, all in the window; "
                             f"{sweeps} sweeps x {repeats}, median",
               stream_sweep_ms=[t * 1e3 for t in per],
               stream_in_memory_fps=batch / statistics.median(mem),
               stream_in_memory_sweep_ms=[t * 1e3 for t in mem],
               stream_caps=dict(STREAM_CAPS), stream_max_counts=most,
               stream_h2d_ceiling_fps=None, stream_h2d_MBps=None)
    h2d = h2d_ceiling((batch,) + frames[0].shape, dev)
    if h2d is not None:
        out.update(stream_h2d_ceiling_fps=batch / h2d,
                   stream_h2d_MBps=batch * frames[0].nbytes / h2d / 1e6)
    return out


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or f"{torch.cuda.get_device_name(dev)}, power limit not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sift_tpu_torch.bench",
                                 description="SIFT detect + describe + match throughput")
    ap.add_argument("--batch", type=int, default=16, help="frames a sweep (even)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--sweeps", type=int, default=10, help="device-resident sweeps a repeat")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--stream-sweeps", type=int, default=6)
    ap.add_argument("--stream-repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sift_tpu_torch.bench: no CUDA device; the bench measures the card "
              "(pass --device cpu to run it on the CPU)", file=sys.stderr)
        return 2
    if args.batch < 2 or args.batch % 2:
        ap.error(f"--batch must be even and at least 2, got {args.batch}")
    if min(args.sweeps, args.repeats, args.stream_sweeps, args.stream_repeats) < 1:
        ap.error("sweeps and repeats must be at least 1")
    dev = torch.device(args.device)
    res = resident(args.batch, args.sweeps, args.repeats, dev)
    stream = streaming(args.batch, args.stream_sweeps, args.stream_repeats, dev)
    print(json.dumps(dict(
        metric=METRIC, value=res["value"], unit="frames/s",
        vs_baseline=res["value"] / BASELINE_FPS, best=res["best"], batch=args.batch,
        method=f"{args.sweeps} sweeps (entry point + matcher) then one synchronise, median "
               f"and best of {args.repeats}; the entry point reads the host inside its "
               f"stages, so the sweeps do not queue ahead of the device",
        sweep_ms=res["sweep_ms"], caps=dict(PAIR_CAPS), **stream,
        device=device_line(dev))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
