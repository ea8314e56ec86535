"""The streaming path of ``sift_tpu_torch.bench`` on the CPU, at small
sizes: the capacity-honesty scan, the loader-to-matches loop of the
scene-throughput script against the library on frames held in memory,
``as_batch`` on uint8 and float input, and the bench's refusal to run
without a card unless asked for the CPU."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sift_tpu_torch import SiftConfig, detect_and_describe_batch, match_descriptors
from sift_tpu_torch import bench, cli
from sift_tpu_torch.models.sift import clipped
from sift_tpu_torch.utils import native
from sift_tpu_torch.utils.keypoints import FIELDS

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
CFG = SiftConfig(extrema_cap=512, kp_cap=256, ori_cap=512)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def crops():
    """Five 64 x 96 crops of consecutive CAVE-01 frames, uint8."""
    return [np.load(DATA / "scene_oracle" / f"cave01_{i:02d}.npz")["input"][250:314, 100:196]
            for i in range(5)]


@pytest.fixture(scope="module")
def pngs(crops, tmp_path_factory):
    if not native.available():
        pytest.skip("the native library does not build here (g++, libjpeg / libpng headers)")
    return bench.write_pngs(crops, tmp_path_factory.mktemp("crops"))


def test_check_counts_names_a_planted_clip(crops):
    tiny = SiftConfig(extrema_cap=16, kp_cap=8, ori_cap=8)
    _, counts = detect_and_describe_batch(np.stack(crops[:2]), tiny, return_counts=True,
                                          device="cpu")
    with pytest.raises(bench.CapacityError, match=r"frame 0: extrema \d+ > cap 16"):
        bench.check_counts(counts, tiny, "planted")
    _, counts = detect_and_describe_batch(np.stack(crops[:2]), CFG, return_counts=True,
                                          device="cpu")
    bench.check_counts(counts, CFG, "the test's capacities")
    # A Newton phase above its cap, with every other count within its own.
    planted = {k: v.clone() for k, v in counts.items()}
    planted["refine_active"][1, 1] = 129
    with pytest.raises(bench.CapacityError, match=r"frame 1: refine_active\[1\] 129 > cap 128"):
        bench.check_counts(planted, CFG, "planted")
    assert clipped(planted, CFG, frames=1) == []


def test_one_capacity_rule_for_the_cli_and_the_bench(capsys):
    """``models.sift.clipped`` on one planted set of counts: the CLI warns
    once a count, at the batch's most; the bench names every frame."""
    cfg = SiftConfig()  # capacities 8192 / 4096 / 8192, phases 2048 / 1024, 8 slots
    counts = dict(extrema=torch.tensor([9000, 10]), refined=torch.tensor([5000, 4097]),
                  oriented=torch.tensor([10, 8193]), ori_slots_max=torch.tensor(9),
                  refine_active=torch.tensor([[2049, 1024], [10, 1025]]))
    cli._warn_capacity_overflow(counts, cfg, "a.png: ")
    tail = "; detections were clipped — raise SiftConfig caps"
    assert capsys.readouterr().err.splitlines() == [
        f"a.png: warning: {c}{tail}" for c in (
            "extrema count 9000 exceeds capacity 8192", "refined count 5000 exceeds capacity 4096",
            "oriented count 8193 exceeds capacity 8192", "ori_slots_max count 9 exceeds capacity 8",
            "refine_active[0] count 2049 exceeds capacity 2048",
            "refine_active[1] count 1025 exceeds capacity 1024")]
    want = ("frame 0: extrema 9000 > cap 8192; frame 0: refined 5000 > cap 4096; "
            "frame 1: refined 4097 > cap 4096; frame 1: oriented 8193 > cap 8192; "
            "frame None: ori_slots_max 9 > cap 8; frame 0: refine_active[0] 2049 > cap 2048; "
            "frame 1: refine_active[1] 1025 > cap 1024")
    with pytest.raises(bench.CapacityError) as err:
        bench.check_counts(counts, cfg, "planted")
    assert str(err.value) == f"planted: {want}"
    assert [c["frame"] for c in clipped(counts, cfg, frames=1, first=5)] == [5, 5, None, 5]


def test_honesty_scan_raises_on_the_stream(pngs, crops):
    """The scan returns the largest counts of the frames it read, and at a
    capacity that only the busiest frame exceeds it names that frame by its
    place in the stream (past the first batch; the last batch is padded)."""
    _, counts = detect_and_describe_batch(np.stack(crops), CFG, return_counts=True, device="cpu")
    most = bench.honesty_scan(pngs, CFG, batch=2, threads=2, device="cpu")
    assert most["extrema"] == int(counts["extrema"].max())
    assert most["refine_active"] == counts["refine_active"].max(0).values.tolist()
    extrema = counts["extrema"].tolist()
    cap = sorted(extrema)[-2]
    over = [f for f, v in enumerate(extrema) if v > cap]
    assert len(over) == 1 and over[0] >= 2
    want = f"frame {over[0]}: extrema {extrema[over[0]]} > cap {cap}"
    with pytest.raises(bench.CapacityError, match=f"^stream: {want}$"):
        bench.honesty_scan(pngs, SiftConfig(extrema_cap=cap, kp_cap=256, ori_cap=512), batch=2,
                           threads=2, device="cpu")


def test_scene_loop_equals_the_library_in_memory(pngs, crops):
    """Batch 2 over five frames (the last batch padded), then the four
    consecutive pairs in chunks: every frame's buffer equals the entry
    point on the five frames held in memory, and every pair's matches the
    matcher's."""
    kp, (idx, acc) = bench.scene_matches(pngs, CFG, batch=2, threads=2, device="cpu")
    ref = detect_and_describe_batch(np.stack(crops), CFG, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(kp, f), getattr(ref, f)), f
    assert kp.valid.sum(1).min() > 10
    assert tuple(acc.shape) == (4, CFG.ori_cap)
    for p in range(4):
        ri, ra, _, _ = match_descriptors(ref.desc[p], ref.valid[p], ref.desc[p + 1],
                                         ref.valid[p + 1], CFG.ratio_threshold, device="cpu")
        assert torch.equal(acc[p], ra) and torch.equal(idx[p][ra], ri[ra]), p
    assert acc.sum() > 0


def test_stream_sweeps_and_stage_batches(pngs, crops):
    """Two sweeps of two frames cycle over the paths; the last sweep's
    matches are the in-memory sweep's on frames 2 and 3.  Frames of two
    shapes in one batch are refused."""
    got = bench.stream_sweeps(pngs, CFG, batch=2, sweeps=2, threads=2, device="cpu")
    want = bench.sweep(torch.from_numpy(np.stack(crops[2:4])), CFG, "cpu")
    assert torch.equal(got, want)
    staged = list(bench.stage_batches(iter(crops), 2, "cpu"))
    assert [n for _, n in staged] == [2, 2, 1]
    assert all(t.dtype == torch.uint8 and tuple(t.shape) == (2, 64, 96, 3) for t, _ in staged)
    assert torch.equal(staged[2][0][1], staged[2][0][0])
    assert torch.equal(staged[1][0], torch.from_numpy(np.stack(crops[2:4])))
    with pytest.raises(ValueError, match="shape"):
        list(bench.stage_batches([crops[0], crops[1][:32]], 2, "cpu"))


def test_as_batch_uint8_and_float_give_the_same_keypoints(crops):
    u8 = torch.from_numpy(np.stack(crops[:2]))
    a = detect_and_describe_batch(u8, CFG, device="cpu")
    b = detect_and_describe_batch(u8.float(), CFG, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    from sift_tpu_torch.models.sift import as_batch

    x = as_batch(u8, CFG, "cpu")
    assert x.dtype == torch.float32 and torch.equal(x, u8.float())
    f32 = u8.float()
    assert as_batch(f32, CFG, "cpu").data_ptr() == f32.data_ptr()
    assert torch.equal(as_batch(u8.double() + 0.3, CFG, "cpu"), (u8.double() + 0.3).float())


def test_bench_without_a_card_names_the_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench runs on it")
    out = subprocess.run([sys.executable, "-m", "sift_tpu_torch.bench"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
    assert out.stdout.strip() == ""
