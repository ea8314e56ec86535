"""Whole-scene parity audit of the port (sift_tpu_torch) against the
reference's dumps: the counterpart of ``scripts/verify_scene_parity.py``.

For every frame of a scene with oracle dumps (tests/data/scene_oracle/,
produced by tests/oracle/harness.cpp over the unmodified reference) and
every edge of its graph:

* default, the production sweep on the card (float32, the entry point
  ``detect_and_describe_batch`` in batches of 8, ``--caps`` extrema, kp,
  ori, default 6144,1536,2048): first the bench-capacity anchor (the CAVE-01
  00<->01 pair must give the reference's 165-match set), then per frame the
  keypoint count and the share of oracle keypoints with one of ours within
  5e-2 px, per edge the Lowe match set against the oracle's as a matched-
  coordinate multiset (5e-2 px) and the bijective overlap; ``--provenance``
  sorts each differing match of a non-exact edge into ``kp-miss`` or
  ``ratio-flip`` with the exact-integer Lowe margin.  Every true stage
  count is checked against its capacity: a clipped frame stops the run.
  The summary adds the descriptor bytes that differ from the oracle's on
  the keypoints that pair with the oracle's by the benchmark's rule
  (``benchmark/judge.pair_keypoints``).
  The summary adds each hand-written kernel's launches.
* ``--f64``, the parity profile on the CPU (float64 ``detect_stages``):
  per frame the keypoint set (x, y and size exact, pori at 1e-9) and the
  descriptor bytes, per edge the exact-integer Lowe match count on both
  sides.

The graph is ``--graph`` (a STITCH-GRAPH file) where that file exists, else
the chain (i, i + 1); the summary names which.  Prints one JSON line per
frame and edge and a summary, with the JAX script's keys.

    python scripts/torch_verify_scene_parity.py [--limit N] [--caps E,K,O]
        [--provenance] [--graph FILE] [--device cpu] [--f64]

Runs on the card unless ``--device cpu`` or ``--f64``; without a card it
raises.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.judge import pair_keypoints  # noqa: E402
from sift_tpu_torch import SiftConfig, match_descriptors  # noqa: E402
from sift_tpu_torch.bench import check_counts, device_line  # noqa: E402
from sift_tpu_torch.models.sift import detect_and_describe_batch, detect_stages  # noqa: E402
from sift_tpu_torch.parallel.multihost import kernel_wrappers  # noqa: E402
from sift_tpu_torch.utils.numerics import resolve_device  # noqa: E402
from sift_tpu_torch.utils.stitch_graph import chain_graph, parse_stitch_graph  # noqa: E402

BENCH_CAPS = (6144, 1536, 2048)
BATCH = 8
TOL_PX = 5e-2


def _oracle_match_pairs(ref0: dict, ref1: dict):
    """The reference's Lowe-ratio match set from the oracle descriptors
    (exact integer matcher, src/sift.cpp:783-815): list of coordinate
    quadruple pairs ((x0,y0,size0,pori0), (x1,y1,size1,pori1))."""
    d0 = ref0["final.desc"].astype(np.int64)
    d1 = ref1["final.desc"].astype(np.int64)
    d2 = (
        (d0 * d0).sum(1)[:, None] + (d1 * d1).sum(1)[None, :] - 2 * (d0 @ d1.T)
    )
    bi = d2.argmin(1)
    b = d2[np.arange(len(d0)), bi]
    d2m = d2.copy()
    d2m[np.arange(len(d0)), bi] = 1 << 60
    s = d2m.min(1)
    acc = 16 * b < 9 * s
    co0 = np.stack([ref0["final.x"], ref0["final.y"]], 1)
    co1 = np.stack([ref1["final.x"], ref1["final.y"]], 1)
    rows = np.nonzero(acc)[0]
    return np.concatenate([co0[rows], co1[bi[rows]]], 1)


def _coord_multiset_match(mine: np.ndarray, ref: np.ndarray, tol: float) -> bool:
    """True iff two (N, 4) coordinate-pair MULTISETS agree row-wise within
    ``tol`` after lexicographic sort.

    Multiset, not set: multi-orientation keypoints at one location yield
    several legitimate matches with identical coordinate quadruples (pori is
    not part of the quadruple), so a bijective nearest-neighbor check
    spuriously fails on those ties.  Exactly-equal rows sort identically on
    both sides; distinct keypoints are either identical or far apart
    relative to the f32-vs-f64 wiggle (~1e-3 px), so sorted row-wise
    comparison is stable.
    """
    if mine.shape != ref.shape:
        return False
    if len(mine) == 0:
        return True
    ms = mine[np.lexsort(mine.T[::-1])]
    rs = ref[np.lexsort(ref.T[::-1])]
    return bool((np.abs(ms - rs).max() <= tol))


def _edge_provenance(kpa, kpb, ora, orb, mine, ref_pairs):
    """Classify every differing match of a non-exact edge.

    For each oracle match with no 5e-2 coordinate twin on our side (and
    vice versa), report WHY it flipped:
      - ``kp-miss``: one endpoint keypoint exists in only one set — a
        detection-level flip (threshold-marginal extremum or Newton
        convergence at the f32/f64 boundary);
      - ``ratio-flip``: both endpoints exist in both sets — the Lowe
        accept decision differed; the reported ``margin`` is the exact
        integer predicate slack 9*second^2 - 16*best^2 on the ORACLE
        descriptors (tiny |margin| = a genuinely marginal match whose
        +-1-byte f32 descriptor rounding can flip it).

    ``kpa`` / ``kpb``: keypoint buffers on the host (fields ``valid``,
    ``x``, ``y``).
    """
    import numpy as _np

    va = _np.asarray(kpa.valid)
    vb = _np.asarray(kpb.valid)
    my_a = _np.stack([_np.asarray(kpa.x)[va], _np.asarray(kpa.y)[va]], 1)
    my_b = _np.stack([_np.asarray(kpb.x)[vb], _np.asarray(kpb.y)[vb]], 1)
    ref_a = _np.stack([ora["final.x"], ora["final.y"]], 1)
    ref_b = _np.stack([orb["final.x"], orb["final.y"]], 1)
    da = ora["final.desc"].astype(_np.int64)
    db = orb["final.desc"].astype(_np.int64)
    d2 = ((da * da).sum(1)[:, None] + (db * db).sum(1)[None, :]
          - 2 * (da @ db.T))

    def has_near(pt, pts):
        if not len(pts):
            return False
        return bool((_np.abs(pts - pt[None]).max(1) <= 5e-2).any())

    def unmatched(src, dst):
        if not len(src):
            return []
        if not len(dst):
            return list(range(len(src)))
        d = _np.abs(src[:, None, :] - dst[None, :, :]).max(-1)
        used = _np.zeros(len(dst), bool)
        out = []
        for s in range(len(src)):
            cand = _np.nonzero((d[s] <= 5e-2) & ~used)[0]
            if len(cand):
                used[cand[0]] = True
            else:
                out.append(s)
        return out

    diffs = []
    for side, src, dst in (("ref-only", ref_pairs, mine),
                           ("mine-only", mine, ref_pairs)):
        for s in unmatched(src, dst):
            qa, qb = src[s, :2], src[s, 2:]
            have_a = has_near(qa, my_a) and has_near(qa, ref_a)
            have_b = has_near(qb, my_b) and has_near(qb, ref_b)
            kind = "ratio-flip" if (have_a and have_b) else "kp-miss"
            entry = dict(side=side, kind=kind,
                         a=[round(float(qa[0]), 2), round(float(qa[1]), 2)],
                         b=[round(float(qb[0]), 2), round(float(qb[1]), 2)])
            if kind == "ratio-flip":
                # Exact-int Lowe margin on the oracle descriptors for the
                # a-endpoint's row: slack of 16*best^2 < 9*second^2.
                ia = int(_np.abs(ref_a - qa[None]).max(1).argmin())
                row = d2[ia].copy()
                bi = int(row.argmin())
                best = int(row[bi])
                row[bi] = 1 << 60
                second = int(row.min())
                entry["margin"] = int(9 * second - 16 * best)
                entry["best2"] = best
            diffs.append(entry)
    return diffs


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def load_scene(directory: str, limit: int = 0):
    """(frame order, {frame: oracle dict}) of the scene's ``*.npz`` dumps,
    sorted by name, the first ``limit`` (0: all)."""
    dumps = sorted(glob.glob(os.path.join(directory, "*.npz")))
    if limit:
        dumps = dumps[:limit]
    oracle = {}
    for path in dumps:
        frame = int(os.path.basename(path).split("_")[-1].split(".")[0])
        oracle[frame] = dict(np.load(path))
    return list(oracle), oracle


def scene_graph(path: str | None, frames: list[int]):
    """(edges, graph name): the STITCH-GRAPH file's edges where ``path``
    names a file that exists, else the chain (i, i + 1) over the frames."""
    if path and os.path.isfile(path):
        return parse_stitch_graph(path).edges, path
    return chain_graph(max(frames) + 1).edges, "chain"


def match_pairs(kpa, kpb, cfg: SiftConfig, dev) -> np.ndarray:
    """(N, 4) float64 coordinate quadruples of the accepted Lowe matches of
    ``kpa`` against ``kpb`` (one frame's buffers each)."""
    idx, acc, _, _ = match_descriptors(kpa.desc, kpa.valid, kpb.desc, kpb.valid,
                                       cfg.ratio_threshold, device=dev)
    idx, acc = idx.cpu().numpy(), acc.cpu().numpy()
    xa, ya, xb, yb = (t.cpu().numpy() for t in (kpa.x, kpa.y, kpb.x, kpb.y))
    rows = np.nonzero(acc & kpa.valid.cpu().numpy())[0]
    return np.stack([xa[rows], ya[rows], xb[idx[rows]], yb[idx[rows]]], 1).astype(np.float64)


def pair_anchor(dev) -> dict:
    """Bench-capacity anchor: the CAVE-01 00<->01 pair at 6144 / 1536 /
    2048 through the entry point at batch 2 must give the reference's
    165-match set."""
    cfg = SiftConfig(extrema_cap=BENCH_CAPS[0], kp_cap=BENCH_CAPS[1], ori_cap=BENCH_CAPS[2])
    data = os.path.join(ROOT, "tests", "data")
    r0 = dict(np.load(os.path.join(data, "oracle_cave00.npz")))
    r1 = dict(np.load(os.path.join(data, "oracle_cave01.npz")))
    imgs = np.stack([r0["input"], r1["input"]]).astype(np.float32)
    kp = detect_and_describe_batch(imgs, cfg, device=dev)
    mine = match_pairs(kp.map(lambda a: a[0]), kp.map(lambda a: a[1]), cfg, dev)
    ref = _oracle_match_pairs(r0, r1)
    ok = len(mine) == len(ref) == 165 and _coord_multiset_match(mine, ref, tol=TOL_PX)
    return dict(anchor="bench-caps CAVE-01 00<->01", matches=int(len(mine)),
                oracle=int(len(ref)), set_exact=bool(ok))


def overlap(mine: np.ndarray, ref: np.ndarray) -> int:
    """Oracle matches reproduced: greedy 1:1 assignment within 5e-2 px on
    the coordinate quadruple."""
    if not len(mine) or not len(ref):
        return 0
    d = np.abs(mine[:, None, :] - ref[None, :, :]).max(-1)
    used = np.zeros(len(mine), bool)
    n = 0
    for rj in range(len(ref)):
        cand = np.nonzero((d[:, rj] <= TOL_PX) & ~used)[0]
        if len(cand):
            used[cand[0]] = True
            n += 1
    return n


def production_sweep(args, caps, dev) -> dict:
    """The float32 production sweep on ``dev``; returns the summary."""
    cfg = SiftConfig(extrema_cap=caps[0], kp_cap=caps[1], ori_cap=caps[2])
    order, oracle = load_scene(args.scene_oracle, args.limit)
    kps = {}
    for lo in range(0, len(order), BATCH):
        chunk = order[lo:lo + BATCH]
        pad = chunk + [chunk[-1]] * (BATCH - len(chunk))
        imgs = np.stack([oracle[f]["input"] for f in pad]).astype(np.float32)
        kp, counts = detect_and_describe_batch(imgs, cfg, return_counts=True, device=dev)
        # Capacity honesty: a clipped frame would silently lose coverage.
        check_counts(counts, cfg, f"frames {chunk} (re-run with --caps sized for the scene)",
                     frames=len(chunk), first=lo)
        for n, f in enumerate(chunk):
            kps[f] = kp.map(lambda a, n=n: a[n])

    host = {f: kp.map(lambda a: a.cpu()) for f, kp in kps.items()}
    frames_ok = paired = bytes_off = 0
    for f in order:
        kp = host[f]
        v = kp.valid.numpy()
        mine = np.stack([kp.x.numpy()[v], kp.y.numpy()[v]], 1).astype(np.float64)
        ref = np.stack([oracle[f]["final.x"], oracle[f]["final.y"]], 1)
        # descriptor bytes of the keypoints that pair with the oracle's
        # (the benchmark's rule: 0.01 px, 0.1% of size, 0.01 rad)
        fields = ("x", "y", "size", "pori", "octave", "layer", "desc")
        pairing = pair_keypoints({n: getattr(kp, n).numpy()[v] for n in fields},
                                 {n: oracle[f][f"final.{n}"] for n in fields})
        hit = pairing >= 0
        paired += int(hit.sum())
        bytes_off += int((kp.desc.numpy()[v][hit] != oracle[f]["final.desc"][pairing[hit]]).sum())
        # coverage: every oracle keypoint has a mine within 5e-2 px
        d = np.abs(mine[:, None, :] - ref[None, :, :]).max(-1)
        cov = float((d.min(0) <= TOL_PX).mean()) if len(mine) else 0.0
        ok = bool(cov == 1.0 and abs(len(mine) - len(ref)) <= 2)
        frames_ok += ok
        emit(dict(frame=f, keypoints=len(ref), mine=int(len(mine)),
                  oracle_coverage=round(cov, 4), ok=ok))

    edges, graph = scene_graph(args.graph, order)
    edges_ok = edges_total = 0
    for i, j in edges:
        if i not in kps or j not in kps:
            continue
        edges_total += 1
        mine = match_pairs(kps[i], kps[j], cfg, dev)
        ref_pairs = _oracle_match_pairs(oracle[i], oracle[j])
        ok = bool(len(mine) == len(ref_pairs)
                  and _coord_multiset_match(mine, ref_pairs, tol=TOL_PX))
        edges_ok += ok
        rec = dict(edge=[i, j], matches=int(len(mine)), ref_matches=int(len(ref_pairs)),
                   set_exact=ok, overlap=overlap(mine, ref_pairs))
        if not ok and args.provenance:
            rec["provenance"] = _edge_provenance(host[i], host[j], oracle[i], oracle[j],
                                                 mine, ref_pairs)
        emit(rec)
    return dict(summary=True, profile=f"f32-{dev.type}-production (sift_tpu_torch, "
                f"{device_line(dev)})", caps=list(caps), frames=len(order),
                frames_ok=frames_ok, edges=edges_total, edges_ok=edges_ok, graph=graph,
                desc_paired=paired, desc_bytes_off=bytes_off,
                desc_bytes_off_pct=100.0 * bytes_off / max(1, 128 * paired))


def launches() -> dict:
    """Each hand-written kernel's launches in this process so far."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def _keyed(x, y, size, pori, desc, valid) -> dict:
    """{(x, y, size, pori rounded to 9 decimals): descriptor} of the valid
    lanes."""
    return {(float(x[i]), float(y[i]), float(size[i]), round(float(pori[i]), 9)): desc[i]
            for i in np.nonzero(valid)[0]}


def parity_sweep(args) -> dict:
    """The float64 parity profile on the CPU; returns the summary."""
    cfg = SiftConfig(dtype=torch.float64)
    order, oracle = load_scene(args.scene_oracle, args.limit)
    kps = {}
    frames_ok = 0
    for f in order:
        d = oracle[f]
        ref = _keyed(d["final.x"], d["final.y"], d["final.size"], d["final.pori"],
                     d["final.desc"], np.ones(len(d["final.x"]), bool))
        img = d["input"].astype(np.float64)
        octaves = cfg.octaves_count(img.shape[1] * 2, img.shape[0] * 2)
        kp = detect_stages(img, cfg, octaves, device="cpu")["final"]
        kps[f] = kp
        mine = _keyed(*(getattr(kp, n).numpy() for n in ("x", "y", "size", "pori", "desc",
                                                          "valid")))
        keys_equal = set(mine) == set(ref)
        byte_diffs = (
            sum(int((mine[k] != ref[k]).sum()) for k in ref) if keys_equal else -1
        )
        ok = keys_equal and byte_diffs == 0
        frames_ok += ok
        emit(dict(frame=f, keypoints=len(ref), keys_equal=keys_equal,
                  desc_byte_diffs=byte_diffs, ok=bool(ok)))

    edges, graph = scene_graph(args.graph, order)
    edges_ok = edges_total = 0
    for i, j in edges:
        if i not in kps or j not in kps:
            continue
        edges_total += 1
        kpa, kpb = kps[i], kps[j]
        _, acc, _, _ = match_descriptors(kpa.desc, kpa.valid, kpb.desc, kpb.valid,
                                         cfg.ratio_threshold, device="cpu")
        mine_count = int(acc.sum())
        ref_count = len(_oracle_match_pairs(oracle[i], oracle[j]))
        ok = mine_count == ref_count
        edges_ok += ok
        emit(dict(edge=[i, j], matches=mine_count, ref_matches=ref_count, ok=bool(ok)))
    return dict(summary=True, profile="f64-cpu-parity (sift_tpu_torch)", frames=len(order),
                frames_ok=frames_ok, edges=edges_total, edges_ok=edges_ok, graph=graph)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--limit", type=int, default=0, help="first N frames only")
    ap.add_argument("--provenance", action="store_true",
                    help="production sweep: classify every differing match of each non-exact "
                    "edge (kp-miss vs ratio-flip with the exact-int Lowe margin)")
    ap.add_argument("--caps", default=None,
                    help="extrema,kp,ori capacities of the production sweep (default "
                    "6144,1536,2048, the bench's; busier scene frames need larger ones, and "
                    "a clipped count stops the run)")
    ap.add_argument("--f64", action="store_true",
                    help="the float64 parity profile on the CPU instead of the production sweep")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the production sweep's device (default cuda)")
    ap.add_argument("--scene-oracle", default=os.path.join(ROOT, "tests", "data", "scene_oracle"))
    ap.add_argument("--graph", default=None,
                    help="STITCH-GRAPH file; without it (or where it is absent) the chain graph")
    return ap


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.f64:
        if args.device == "cuda":
            parser.error("--f64 is the CPU parity profile; drop --device cuda")
        emit(parity_sweep(args))
        return 0
    dev = resolve_device(args.device or "cuda")
    caps = tuple(int(x) for x in args.caps.split(",")) if args.caps else BENCH_CAPS
    # The bench-capacity anchor first (the exact-165 contract).
    emit(pair_anchor(dev))
    emit(dict(production_sweep(args, caps, dev), launches=launches()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
