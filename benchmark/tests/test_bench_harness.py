"""The harness on the CPU: every mix drives its requests through the
program at a small size and the judge finds it correct; a new
configuration and traffic file, and a new order and client, become a cell
without an edit; each order repeats for a seed and changes with it;
without a card the entry command exits without a result."""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

torch.set_num_threads(2)
HERE = Path(harness.ROOT) / "benchmark"
TRAFFIC = sorted((HERE / "traffic").glob("*.json"))
SEED = 2**33 + 5
# A client with open-loop arrivals and an order of every other frame: what
# a later cell would add as files.
PACED_CLIENT = '''
import time

from benchmark.clients.detect_match import Client as Base


class Client(Base):
    def drive(self, reqs, window):
        gap, due = 1.0 / self.mix["rate"], time.perf_counter()
        while window.running():
            req = next(reqs, None)
            if req is None:
                return
            time.sleep(max(0.0, due - time.perf_counter()))
            window.send(req, self.request, t0=due)
            due += gap
'''
STRIDE_ORDER = '''
import itertools

from benchmark.traffic import rng


def requests(mix, n_frames, seed):
    start = int(rng(seed, 3).integers(n_frames))
    for k in itertools.count(-1):
        frames = [(start + 2 * (k * mix["batch"] + i)) % n_frames for i in range(mix["batch"])]
        yield dict(index=k, frames=frames, flip=0, pairs=[(i - 1, i) for i in range(mix["batch"])])
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    extra = {"walk_b4": dict(client="detect_match", source="device", order="walk", batch=4,
                             check_requests=1, why="a mix that only a data file adds"),
             "paced_stride": dict(client="paced", source="device", order="stride", batch=2,
                                  rate=50, check_requests=1,
                                  why="a mix whose client and order are new files")}
    files = {"clients/paced.py": PACED_CLIENT, "orders/stride.py": STRIDE_ORDER}
    return tiny.make(tmp_path_factory.mktemp("checkout"), extra, files)


def run(root, cell, trace=False, program=None):
    hooks = dict(root=root, frames=tiny.crop)
    if program:
        hooks["program"] = program
    return harness.run_cell(cell, SEED, 0.01, trace, "cpu", hooks=hooks)


def plain(reqs):
    return json.dumps(reqs, default=lambda a: np.asarray(a).tolist())


@pytest.mark.parametrize("path", TRAFFIC, ids=lambda p: p.stem)
def test_traffic_repeats_for_a_seed_and_moves_with_it(path):
    mix = json.loads(path.read_text())
    order = harness.load_module(HERE, "orders", mix["order"])
    first = list(itertools.islice(order.requests(mix, 35, 12345), 6))
    again = list(itertools.islice(order.requests(mix, 35, 12345), 6))
    other = list(itertools.islice(order.requests(mix, 35, 2**40 + 7), 6))
    assert plain(first) == plain(again)
    assert plain(first) != plain(other)
    assert all(len(r["frames"]) == len(first[0]["frames"]) for r in first + other)


def test_walk_is_a_ping_pong_through_every_frame():
    at = harness.load_module(HERE, "orders", "walk").walk_frames(5, 99)
    steps = [at(k) for k in range(16)]
    assert all(abs(a - b) == 1 for a, b in zip(steps, steps[1:]))
    assert set(steps) == set(range(5))


@pytest.mark.parametrize("mix", sorted(tiny.MIXES))
def test_each_mix_runs_and_is_correct_on_the_cpu(root, mix):
    cell = f"tiny_{tiny.MIXES[mix]}.{mix}"
    result, lines = run(root, cell, trace=mix == "resident_b16")
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) >= {"keypoints_unpaired_pct", "matches_off_pct"}
    assert "setup_s" in result["metrics"] or mix == "resident_b16"


@pytest.mark.parametrize("mix", ["walk_b4", "paced_stride"])
def test_a_new_config_and_mix_become_a_cell_without_an_edit(root, mix):
    result, lines = run(root, f"tiny_cave_vga.{mix}")
    assert result["correct"], lines
    assert {"setup_s"} <= set(result["metrics"])


def test_entry_command_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "cave_vga.resident_b16", "--seed", "1", "--seconds", "1"],
                          cwd=harness.ROOT, capture_output=True, text=True)
    assert proc.returncode == 2 and proc.stdout == ""
