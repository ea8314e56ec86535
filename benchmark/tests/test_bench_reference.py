"""The plain reference held to the C++ oracle (``tests/data``) on the CPU
in float32: the CAVE-01 pair's 677 / 1067 keypoints and its 165-match
set, the demo pair's 1286 keypoints and 1429 of the oracle's 1430 (float32
parts from the float64 oracle at one keypoint of the second frame, in
stage 1)."""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import judge
from benchmark.reference import match_plain, sift_plain

DATA = Path(__file__).resolve().parents[2] / "tests" / "data"
torch.set_num_threads(2)


@functools.cache
def oracle(name):
    o = np.load(DATA / f"oracle_{name}.npz")
    kp = {k: o[f"final.{k}"] for k in judge.FIELDS + ("desc",)}
    return o["input"], kp


@functools.cache
def reference(name):
    img, _ = oracle(name)
    kp = sift_plain.describe(torch.from_numpy(img), {})
    return {k: kp[k].numpy() for k in judge.FIELDS + ("desc",)}


@pytest.mark.parametrize("name, count, unpaired", [
    ("cave00", 677, 0), ("cave01", 1067, 0), ("demo1", 1286, 0), ("demo2", 1429, 1)])
def test_keypoints_pair_with_the_oracle(name, count, unpaired):
    ref, (_, want) = reference(name), oracle(name)
    pairing = judge.pair_keypoints(ref, want)
    assert len(ref["x"]) == count
    assert int((pairing < 0).sum()) == 0
    assert len(want["x"]) - int((pairing >= 0).sum()) == unpaired


def test_cave_match_set_is_the_oracles():
    """The reference's matches on the CAVE pair are the 165 that the
    oracle's own descriptors give, read through the pairing."""
    mine = [reference(n) for n in ("cave00", "cave01")]
    want = [oracle(n)[1] for n in ("cave00", "cave01")]
    pairings = [judge.pair_keypoints(m, w) for m, w in zip(mine, want)]
    m = match_plain.ratio_matches(*(torch.from_numpy(k["desc"]) for k in mine))
    w = match_plain.ratio_matches(*(torch.from_numpy(k["desc"]) for k in want))
    got = {(int(pairings[0][i]), int(pairings[1][int(m[0][i])])) for i in np.nonzero(m[1].numpy())[0]}
    oracle_set = {(int(i), int(w[0][i])) for i in np.nonzero(w[1].numpy())[0]}
    assert len(got) == len(oracle_set) == 165
    assert got == oracle_set


def test_ratio_matches_ties_and_empty_sets():
    d = torch.zeros((3, 128), dtype=torch.uint8)
    d[1, 0] = 10
    t = torch.stack([d[0], d[0], d[1]])
    idx, acc, best = match_plain.ratio_matches(d, t)
    assert idx.tolist() == [0, 2, 0]  # the first column wins a tie
    assert acc.tolist() == [False, True, False]  # a copy of the best is second
    assert best.tolist() == [0, 0, 0]
    idx, acc, _ = match_plain.ratio_matches(d, t[:0])
    assert not acc.any()
