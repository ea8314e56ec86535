"""A run with the timed path broken underneath comes out not correct: the
harness on the CPU at a small size (``tiny``), the program's entry points
wrapped with each fault a cell can have.  A fault of the exchange between
chips has no cell here: every cell takes one chip.  The control (the
reference in TF32 in the program's place; the rounding is computed, so it
runs on the CPU too) is not correct either, and a sound float32 program
(the reference with its sums in another order) is."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import clients, control, harness
from benchmark.tests import tiny

torch.set_num_threads(2)
SEED = 2**32 + 11
CELLS = [f"tiny_{c}.{m}" for m, c in sorted(tiny.MIXES.items())]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("checkout"))


def broken(fault: str):
    detect, match = clients.entry_points()
    first = {}

    def d(imgs, cfg, return_counts=False, device="cuda"):
        kp, counts = detect(imgs, cfg, return_counts=True, device=device)
        if fault == "half_batch_left_out":
            b = kp.valid.shape[0]
            valid = kp.valid.clone()
            valid[b - b // 2:] = False
            kp = dataclasses.replace(kp, valid=valid)
        return (kp, counts) if return_counts else kp

    def m(d1, v1, d2, v2, ratio, device="cuda"):
        out = match(d1, v1, d2, v2, ratio, device=device)
        if fault == "answer_altered":  # every answer of the call off by one
            out = ((out[0] + 1) % d2.shape[1],) + tuple(out[1:])
        if fault == "state_unchanged":
            out = first.setdefault("out", out)
        return out
    return d, m


def run(root, cell, program=None, seconds=0.5):
    hooks = dict(root=root, frames=tiny.crop)
    if program:
        hooks["program"] = program
    return harness.run_cell(cell, SEED, seconds, False, "cpu", hooks=hooks)


@pytest.mark.parametrize("fault", ["half_batch_left_out", "answer_altered", "state_unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(root, cell, fault):
    if fault == "half_batch_left_out" and "exhaustive" in cell:
        pytest.skip("the exhaustive cell's window hands no frames to the entry point")
    result, lines = run(root, cell, broken(fault))
    assert not result["correct"], lines


def test_a_frame_altered_in_staging_is_not_correct(root, monkeypatch):
    import sift_tpu_torch.bench as B

    staged = B.stage_batches

    def altered(*a, **k):
        for imgs, n in staged(*a, **k):
            imgs = imgs.clone()
            imgs[0, 0, 0, 0] = 255 - imgs[0, 0, 0, 0]
            yield imgs, n
    monkeypatch.setattr(B, "stage_batches", altered)
    result, lines = run(root, "tiny_cave_vga.png_stream_b16")
    assert not result["correct"], lines
    assert result["checks"]["pixels_off"]["value"] > 0


@pytest.mark.parametrize("variant, correct", [("tf32", False), ("reordered", True)])
@pytest.mark.parametrize("cell", ["tiny_cave_vga.resident_b16", "tiny_demo_pair.cli_pair"])
def test_the_control_is_not_correct_and_a_sound_program_is(root, cell, variant, correct):
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    line = control.readings(cell, SEED, 0.5, dev, hooks=dict(root=root, frames=tiny.crop),
                            variant=variant)
    assert line["correct"] is correct, line
