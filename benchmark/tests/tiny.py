"""A copy of the benchmark in a temporary checkout with one small cell per
traffic mix (the CAVE-01 or demo frames cut to 64 x 96, small
capacities), for the CPU tests."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MIXES = {"resident_b16": "cave_vga", "cli_pair": "demo_pair", "exhaustive_match": "cave_vga",
         "png_stream_b16": "cave_vga"}
CAPS = dict(extrema_cap=1024, kp_cap=256, ori_cap=512)


def crop(frames):
    return [f[:64, :96].copy() for f in frames]


def make(tmp: Path, extra_mixes: dict | None = None, extra_files: dict | None = None) -> Path:
    """A checkout under ``tmp``: ``benchmark/`` copied, ``tests`` linked,
    ``BENCHMARK.json`` naming a cell ``tiny_<config>.<mix>`` per mix;
    ``extra_files``: further files under ``benchmark/``, by path."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp / "tests").symlink_to(ROOT / "tests")
    for rel, text in (extra_files or {}).items():
        (tmp / "benchmark" / rel).write_text(text)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for mix, m in (extra_mixes or {}).items():
        (tmp / "benchmark" / "traffic" / f"{mix}.json").write_text(json.dumps(m))
    mixes = {**MIXES, **{k: "cave_vga" for k in (extra_mixes or {})}}
    for name in set(mixes.values()):
        cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
        cfg["sift"].update(CAPS)
        (tmp / "benchmark" / "configs" / f"tiny_{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append(dict(name=f"tiny_{name}", source="test", reduced=[], why="test",
                                    file=f"benchmark/configs/tiny_{name}.json"))
    for mix, config in mixes.items():
        cell = f"tiny_{config}.{mix}"
        spec["workloads"].append(dict(name=cell, config=f"tiny_{config}", traffic=mix, chips=1,
                                      why="test"))
        limits = json.loads((ROOT / "benchmark" / "limits" / f"{config}.{mix}.json").read_text()
                            if (ROOT / "benchmark" / "limits" / f"{config}.{mix}.json").exists()
                            else (ROOT / "benchmark" / "limits" / "cave_vga.resident_b16.json").read_text())
        (tmp / "benchmark" / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if any(w.endswith("." + mix) for w in m.get("workloads", [])):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
