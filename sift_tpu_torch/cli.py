"""Command-line entry point of the port (the JAX package's ``cli.py``).

``python -m sift_tpu_torch <image1> <image2>`` loads two images, detects
keypoints and descriptors, matches them, and writes ``keypoints1.png``,
``keypoints2.png`` and ``matches.png`` (src/main.cpp:6-20).  It runs on the
CUDA card; ``--device cpu`` runs the float32 profile on the CPU, ``--f64``
the float64 parity profile (on the CPU, as the JAX package's ``--f64``
pins its CPU).  Without a card and without either, it fails.

``python -m sift_tpu_torch stitch <scene_dir>`` stitches a scene directory
into one panorama (``models/stitch.stitch_scene``), on the card unless
``--device cpu`` is given.

Usage:
    python -m sift_tpu_torch <image1> <image2> [--out-dir DIR] [--ratio 0.75] ...
    python -m sift_tpu_torch stitch <scene_dir> [--out panorama.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sift_tpu_torch", description="SIFT detect + match on a CUDA card"
    )
    p.add_argument("image1")
    p.add_argument("image2")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--ratio", type=float, default=0.75)
    p.add_argument("--no-double", action="store_true",
                   help="disable initial 2x upsampling")
    p.add_argument("--sigma", type=float, default=1.6)
    p.add_argument("--intervals", type=int, default=3)
    p.add_argument("--contrast-threshold", type=float, default=0.04)
    p.add_argument("--eigen-ratio", type=float, default=10.0)
    p.add_argument("--f64", action="store_true",
                   help="float64 parity profile (CPU)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where to run (default: cuda; --f64 runs on the CPU)")
    p.add_argument("--no-draw", action="store_true")
    p.add_argument("--json", action="store_true", help="print JSON summary")
    return p


def stitch_main(argv) -> int:
    """``sift_tpu_torch stitch <scene_dir>``: multi-image panorama.

    The scene directory holds numbered images (00.jpg, 01.jpg, ...) and
    optionally a ``*-STITCH-GRAPH.txt`` match graph; without one, a chain
    graph over consecutive images centered on the middle image is used.
    Runs on the card unless ``--device cpu`` is given.
    """
    import glob

    p = argparse.ArgumentParser(prog="sift_tpu_torch stitch")
    p.add_argument("scene_dir")
    p.add_argument("--out", default="panorama.png")
    p.add_argument("--hypotheses", type=int, default=2048)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default: cuda)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sift_tpu_torch stitch: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2

    from sift_tpu_torch import SiftConfig
    from sift_tpu_torch.models.sift import detect_and_describe_batch
    from sift_tpu_torch.models.stitch import stitch_scene
    from sift_tpu_torch.utils.io import load_image, save_image
    from sift_tpu_torch.utils.stitch_graph import chain_graph, parse_stitch_graph

    graphs = glob.glob(os.path.join(args.scene_dir, "*-STITCH-GRAPH.txt"))
    images = sorted(
        f for f in glob.glob(os.path.join(args.scene_dir, "*"))
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    if not images:
        print(f"sift_tpu_torch stitch: no .jpg/.jpeg/.png images in {args.scene_dir}",
              file=sys.stderr)
        return 2
    imgs = [load_image(f) for f in images]
    if graphs:
        graph = parse_stitch_graph(graphs[0])
        if graph.images_count > len(imgs):
            print(
                f"warning: graph declares {graph.images_count} images, "
                f"found {len(imgs)}; stitching the available subset"
            )
            graph = graph.subset(len(imgs))
    else:
        graph = chain_graph(len(imgs))
    # Detection frame by frame with the true stage counts, so that a frame
    # whose detections a capacity clipped is reported, as the pair command
    # reports it.
    cfg = SiftConfig()
    kps = []
    for path, img in zip(images, imgs):
        kp, counts = detect_and_describe_batch(img[None], cfg, return_counts=True,
                                               device=args.device)
        _warn_capacity_overflow(counts, cfg, f"{os.path.basename(path)}: ")
        kps.append(kp.map(lambda a: a[0]))
    pano = stitch_scene(imgs, graph, cfg, num_hypotheses=args.hypotheses, kps=kps,
                        device=args.device)
    save_image(args.out, pano)
    print(f"{args.out}: {pano.shape[1]}x{pano.shape[0]} from {len(imgs)} images")
    return 0


def _warn_capacity_overflow(counts, cfg, prefix: str = "") -> None:
    """Busy images can exceed the fixed stage capacities; the pipeline then
    keeps the first CAP detections (in scan order) instead of erroring.
    Check the true per-stage counts and tell the user to raise the caps
    (SiftConfig(extrema_cap=..., kp_cap=..., ori_cap=...)) when clipped."""
    from sift_tpu_torch.models.sift import clipped

    worst: dict = {}
    for c in clipped(counts, cfg):
        worst[c["count"]] = (max(c["value"], worst.get(c["count"], (0,))[0]), c["cap"])
    for name, (mx, cap) in worst.items():
        print(
            f"{prefix}warning: {name} count {mx} exceeds capacity {cap}; "
            f"detections were clipped — raise SiftConfig caps",
            file=sys.stderr,
        )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "stitch":
        return stitch_main(argv[1:])
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.f64 and args.device == "cuda":
        parser.error("--f64 is the CPU parity profile; drop --device cuda")
    device = "cpu" if args.f64 else (args.device or "cuda")
    if device == "cuda" and not torch.cuda.is_available():
        print("sift_tpu_torch: no CUDA device; pass --device cpu (float32) or --f64 "
              "(float64) to run on the CPU", file=sys.stderr)
        return 2

    from sift_tpu_torch import SiftConfig, detect_and_describe, match_descriptors
    from sift_tpu_torch.models.sift import detect_and_describe_batch
    from sift_tpu_torch.utils import draw
    from sift_tpu_torch.utils.io import load_image, save_image

    cfg = SiftConfig(
        double_image_size=not args.no_double,
        init_sigma=args.sigma,
        intervals=args.intervals,
        contrast_threshold=args.contrast_threshold,
        eigen_ratio=args.eigen_ratio,
        ratio_threshold=args.ratio,
        dtype=torch.float64 if args.f64 else torch.float32,
    )

    t0 = time.time()
    img1 = load_image(args.image1)
    img2 = load_image(args.image2)
    if img1.shape == img2.shape:
        # One batched run also yields the true per-stage counts for the
        # capacity-overflow warning at no extra cost.
        both, counts = detect_and_describe_batch(
            np.stack([img1, img2]), cfg, return_counts=True, device=device
        )
        kp1, kp2 = both.map(lambda a: a[0]), both.map(lambda a: a[1])
        _warn_capacity_overflow(counts, cfg)
    else:
        kp1 = detect_and_describe(img1, cfg, device=device)
        kp2 = detect_and_describe(img2, cfg, device=device)
    idx, accept, _, _ = match_descriptors(
        kp1.desc, kp1.valid, kp2.desc, kp2.valid, cfg.ratio_threshold, device=device
    )
    d1, d2 = kp1.dense(), kp2.dense()  # waits for the device
    accept_np = accept.cpu().numpy()
    elapsed = time.time() - t0

    idx_np = idx.cpu().numpy()
    x1, y1 = kp1.x.cpu().numpy(), kp1.y.cpu().numpy()
    x2, y2 = kp2.x.cpu().numpy(), kp2.y.cpu().numpy()
    pairs = [
        ((float(x1[i]), float(y1[i])), (float(x2[idx_np[i]]), float(y2[idx_np[i]])))
        for i in np.nonzero(accept_np)[0]
    ]

    n1, n2 = len(d1["x"]), len(d2["x"])
    summary = dict(keypoints1=n1, keypoints2=n2, matches=len(pairs), seconds=elapsed)
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"keypoints: {n1} / {n2}; matches: {len(pairs)} in {elapsed:.2f}s")

    if not args.no_draw:
        os.makedirs(args.out_dir, exist_ok=True)
        scales = cfg.intervals + 3
        save_image(os.path.join(args.out_dir, "keypoints1.png"),
                   draw.draw_keypoints(img1, d1, scales))
        save_image(os.path.join(args.out_dir, "keypoints2.png"),
                   draw.draw_keypoints(img2, d2, scales))
        save_image(os.path.join(args.out_dir, "matches.png"),
                   draw.draw_matches(img1, img2, pairs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
