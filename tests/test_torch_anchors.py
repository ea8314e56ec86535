"""The reference's anchors held by the port on the CPU in float64: the demo
pair (755 x 499, 1286 / 1430 keypoints, 269 matches) and the CAVE-01 frames
00-03 (677 / 1067 keypoints and the 165-match set for 00 <-> 01), through
the staged path ``detect_stages`` (the oracle's keypoint sets, 0
descriptor bytes off) and, for the demo pair, through each batch route.
Only tests/data is read.  Tolerance: none; pori is keyed to 1e-9 (libm's
exp / atan2 against glibc's, tests/test_parity_stages.py's contract)."""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import pytest
import torch

from sift_tpu_torch import SiftConfig, match_descriptors
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.models.detect import refine_cascade_caps
from sift_tpu_torch.models.match import ratio_accept
from sift_tpu_torch.ops.top2 import top2_plain

torch.set_num_threads(2)
DATA = pathlib.Path(__file__).parent / "data"
CFG = SiftConfig(dtype=torch.float64, extrema_cap=8192, kp_cap=2048, ori_cap=2048)
COUNTS = dict(demo1=1286, demo2=1430, cave00=677, cave01=1067, cave02=917, cave03=1277)
PAIRS = dict(demo=("demo1", "demo2", 269), cave=("cave00", "cave01", 165))


@functools.cache
def oracle(name):
    return dict(np.load(DATA / f"oracle_{name}.npz"))


def keyed(x, y, size, pori):
    return [(float(a), float(b), float(c), round(float(d), 9)) for a, b, c, d in zip(x, y, size, pori)]


@functools.cache
def staged(name):
    """The staged path's final keypoints of one oracle frame: (keys, desc)."""
    img = oracle(name)["input"]
    octaves = S.octaves_for(S.as_batch(img[None], CFG, "cpu"), CFG)
    st = S.detect_stages(img, CFG, octaves, device="cpu")
    c = st["counts"]
    for o in range(octaves):  # no capacity clipped a real detection
        assert int(c["extrema"][o]) <= CFG.extrema_cap_for_octave(o)
        assert int(c["refined"][o]) <= CFG.kp_cap_for_octave(o)
        assert int(c["oriented"][o]) <= 2 * CFG.kp_cap_for_octave(o)
    assert int(c["final"]) <= CFG.ori_cap
    f = st["final"]
    v = f.valid.numpy()
    return keyed(*(getattr(f, k).numpy()[v] for k in ("x", "y", "size", "pori"))), f.desc.numpy()[v]


def match_set(keys1, desc1, keys2, desc2):
    """Ratio-test matches as pairs of keypoint keys (order-free)."""
    idx, acc, _, _ = match_descriptors(desc1, np.ones(len(desc1), bool), desc2,
                                       np.ones(len(desc2), bool), device="cpu")
    return {(keys1[i], keys2[int(idx[i])]) for i in np.nonzero(acc.numpy())[0]}


@pytest.mark.parametrize("name", COUNTS)
def test_staged_keypoints_and_descriptors(name):
    """The oracle's keypoint set, count and 0 descriptor bytes off."""
    keys, desc = staged(name)
    o = oracle(name)
    want = dict(zip(keyed(o["final.x"], o["final.y"], o["final.size"], o["final.pori"]),
                    o["final.desc"]))
    mine = dict(zip(keys, desc))
    assert len(keys) == len(mine) == COUNTS[name] == len(want)
    assert set(mine) == set(want)
    assert sum(int(np.sum(mine[k] != want[k])) for k in want) == 0


@pytest.mark.parametrize("pair", PAIRS)
def test_staged_match_set(pair):
    """The pair's matches: exactly the anchor's count, and the same set as
    the oracle's own descriptors give through the plain matcher (as
    chip_smoke.py builds the 165-match set)."""
    a, b, n = PAIRS[pair]
    mine = match_set(*staged(a), *staged(b))
    oa, ob = oracle(a), oracle(b)
    ka = keyed(oa["final.x"], oa["final.y"], oa["final.size"], oa["final.pori"])
    kb = keyed(ob["final.x"], ob["final.y"], ob["final.size"], ob["final.pori"])
    d1, d2 = (torch.from_numpy(o["final.desc"])[None] for o in (oa, ob))
    rb, rs, ri = top2_plain(d1, d2, torch.ones(d2.shape[:2], dtype=torch.bool))
    racc = ratio_accept(rb, rs, torch.ones(d1.shape[:2], dtype=torch.bool))[0]
    want = {(ka[i], kb[int(ri[0, i])]) for i in np.nonzero(racc.numpy())[0]}
    assert len(want) == n and mine == want


@pytest.mark.parametrize("route", ["stacks", "front_twin", "twin_rows"])
def test_demo_pair_through_each_batch_route(route):
    """The demo pair at batch 2 through ``run_route``: 1286 / 1430 keypoints
    and 269 matches on every route (in float64 the front-twin route sends
    every octave through its fallback)."""
    imgs = S.as_batch(np.stack([oracle("demo1")["input"], oracle("demo2")["input"]]), CFG, "cpu")
    kp, counts = S.run_route(imgs, CFG, route)
    assert kp.valid.sum(1).tolist() == [COUNTS["demo1"], COUNTS["demo2"]]
    assert int(counts["extrema"].max()) <= CFG.extrema_cap
    for ph, (cap, _) in enumerate(refine_cascade_caps(CFG, CFG.extrema_cap)):
        assert int(counts["refine_active"][:, ph].max()) <= cap
    assert int(counts["oriented"].max()) <= CFG.ori_cap
    _, acc, _, _ = match_descriptors(kp.desc[0], kp.valid[0], kp.desc[1], kp.valid[1], device="cpu")
    assert int(acc.sum()) == PAIRS["demo"][2]
