"""The port's whole-scene audit (``scripts/torch_verify_scene_parity.py``)
against the JAX package's (``scripts/verify_scene_parity.py``) and
``__graft_entry__``'s helpers, on the CPU: its float64 parity profile on
CAVE-01 frames 00-01, its copies of the match-set helpers and of the
provenance classifier on the same seeded inputs, and its production
sweep's records with the JAX script's keys."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import types

import numpy as np
import pytest
import torch

import __graft_entry__ as graft

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT = _load("torch_verify_scene_parity")
JAX = _load("verify_scene_parity")

# The records of the JAX script's production sweep (``--tpu-f32``):
# verify_scene_parity.py:96-99 (frame), :136-140 (edge), :147-150
# (summary), :267-270 (anchor).
JAX_KEYS = dict(anchor={"anchor", "matches", "oracle", "set_exact"},
                frame={"frame", "keypoints", "mine", "oracle_coverage", "ok"},
                edge={"edge", "matches", "ref_matches", "set_exact", "overlap"},
                summary={"summary", "profile", "frames", "frames_ok", "edges", "edges_ok"})


def _lines(capsys) -> list[dict]:
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def _oracles():
    return [dict(np.load(DATA / f"oracle_cave0{i}.npz")) for i in (0, 1)]


def test_f64_profile_frames_00_01(capsys):
    """``--f64 --limit 2``: both frames' keypoint sets equal the oracle's
    (x, y, size exact, pori at 1e-9) with 0 descriptor bytes off, and edge
    0-1 gives the reference's 165 matches.  Tolerance: none."""
    torch.set_num_threads(2)
    assert PORT.main(["--f64", "--limit", "2"]) == 0
    lines = _lines(capsys)
    frames = [r for r in lines if "frame" in r]
    assert frames == [dict(frame=0, keypoints=677, keys_equal=True, desc_byte_diffs=0, ok=True),
                      dict(frame=1, keypoints=1067, keys_equal=True, desc_byte_diffs=0, ok=True)]
    assert [r for r in lines if "edge" in r] == [dict(edge=[0, 1], matches=165, ref_matches=165,
                                                      ok=True)]
    summary = lines[-1]
    assert summary["summary"] and (summary["frames_ok"], summary["edges_ok"]) == (2, 1)
    assert summary["graph"] == "chain"


def test_match_helpers_equal_graft_entry():
    """``_oracle_match_pairs`` and ``_coord_multiset_match`` give
    ``__graft_entry__``'s results on the CAVE pair and on seeded random
    descriptors and coordinate sets.  Tolerance: none (the pairs array is
    compared exactly; the multiset check at 5e-2 px, as the audit runs
    it)."""
    rng = np.random.default_rng(0)
    o0, o1 = _oracles()
    rand = [dict(**{"final.desc": rng.integers(0, 256, (n, 128), dtype=np.uint8)},
                 **{f"final.{c}": rng.uniform(0, 640, n) for c in "xy"}) for n in (60, 75)]
    for a, b in ((o0, o1), (o1, o0), tuple(rand)):
        got, want = PORT._oracle_match_pairs(a, b), graft._oracle_match_pairs(a, b)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    pairs = graft._oracle_match_pairs(o0, o1)
    assert len(pairs) == 165
    perm = rng.permutation(len(pairs))
    cases = [(pairs, pairs), (pairs[perm], pairs), (pairs + 0.04, pairs), (pairs + 0.06, pairs),
             (pairs[:-1], pairs), (pairs[:0], pairs[:0]),
             (np.concatenate([pairs[1:], pairs[:1] + [0, 0, 1, 0]]), pairs)]
    results = []
    for mine, ref in cases:
        want = graft._coord_multiset_match(mine, ref, tol=5e-2)
        assert PORT._coord_multiset_match(mine, ref, tol=5e-2) is want
        results.append(want)
    assert results == [True, True, True, False, False, True, False]


def test_edge_provenance_equals_jax_script():
    """On the CAVE pair with one match lost to a missing keypoint and one
    to the ratio test (rows chosen by a seeded generator), the port's
    classifier gives the JAX script's entries: one ``kp-miss`` and one
    ``ratio-flip`` with its exact-integer margin.  Tolerance: none."""
    o0, o1 = _oracles()
    ref_pairs = graft._oracle_match_pairs(o0, o1)
    rng = np.random.default_rng(3)
    miss, flip = rng.choice(len(ref_pairs), 2, replace=False)
    kp = [types.SimpleNamespace(x=o["final.x"].astype(np.float32),
                                y=o["final.y"].astype(np.float32),
                                valid=np.ones(len(o["final.x"]), bool)) for o in (o0, o1)]
    # Frame 00 loses the keypoint (every orientation of it) behind ``miss``.
    at = (np.abs(o0["final.x"] - ref_pairs[miss, 0]) < 1e-9) & (
        np.abs(o0["final.y"] - ref_pairs[miss, 1]) < 1e-9)
    assert not at[np.abs(o0["final.x"] - ref_pairs[flip, 0]).argmin()]
    kp[0].valid = ~at
    mine = np.delete(ref_pairs, [miss, flip], axis=0) + 1e-3
    want = JAX._edge_provenance(kp[0], kp[1], o0, o1, mine, ref_pairs)
    got = PORT._edge_provenance(kp[0], kp[1], o0, o1, mine, ref_pairs)
    assert got == want
    assert sorted(e["kind"] for e in got) == ["kp-miss", "ratio-flip"]
    assert all(e["side"] == "ref-only" for e in got)
    flipped = next(e for e in got if e["kind"] == "ratio-flip")
    assert isinstance(flipped["margin"], int) and isinstance(flipped["best2"], int)


def test_production_sweep_on_the_cpu_prints_the_jax_records(capsys):
    """``--device cpu --limit 2 --provenance``: the bench-capacity anchor,
    two frames, edge 0-1 and the summary, each record with the JAX
    script's keys (frames and edges exactly those; the anchor and the
    summary add what the port reports: capacities, graph, launches).
    float32 on the CPU: 677 / 1067 keypoints covering the oracle's within
    5e-2 px, and the 165-match set."""
    torch.set_num_threads(2)
    assert PORT.main(["--device", "cpu", "--limit", "2", "--provenance"]) == 0
    lines = _lines(capsys)
    anchor, frames, edges, summary = lines[0], lines[1:3], lines[3:4], lines[4]
    assert set(anchor) == JAX_KEYS["anchor"] and anchor["set_exact"] and anchor["matches"] == 165
    assert all(set(r) == JAX_KEYS["frame"] and r["ok"] for r in frames)
    assert [(r["frame"], r["mine"], r["oracle_coverage"]) for r in frames] == [
        (0, 677, 1.0), (1, 1067, 1.0)]
    assert [set(r) for r in edges] == [JAX_KEYS["edge"]]
    assert edges[0] == dict(edge=[0, 1], matches=165, ref_matches=165, set_exact=True, overlap=165)
    assert JAX_KEYS["summary"] <= set(summary) and summary["graph"] == "chain"
    # Every keypoint pairs with the oracle's; 44 of 223,232 bytes differ
    # (0.0197%), float32 against the reference's float64.
    assert summary["desc_paired"] == 677 + 1067 and summary["desc_bytes_off_pct"] < 0.1
    assert summary["profile"].startswith("f32-cpu-production (sift_tpu_torch")
    assert summary["launches"] == {k: 0 for k in summary["launches"]}  # no kernel on the CPU


def test_graph_file_when_present(tmp_path):
    """``--graph`` names a STITCH-GRAPH file: its edges where the file
    exists, else the chain, and the summary's ``graph`` says which."""
    g = tmp_path / "SCENE-STITCH-GRAPH.txt"
    g.write_text("{images_count | 3}\n{matching_graph_image_edges-0 | 1,2}\n")
    edges, name = PORT.scene_graph(str(g), [0, 1, 2])
    assert name == str(g) and sorted(map(tuple, edges)) == [(0, 1), (0, 2)]
    assert PORT.scene_graph(str(tmp_path / "absent.txt"), [0, 1, 2]) == (((0, 1), (1, 2)), "chain")
    assert PORT.scene_graph(None, [0, 1]) == (((0, 1),), "chain")


def test_f64_on_the_card_is_refused():
    with pytest.raises(SystemExit):
        PORT.main(["--f64", "--device", "cuda"])
