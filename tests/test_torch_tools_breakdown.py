"""The stage breakdown (``scripts/torch_perf_breakdown.py``) against the JAX
package's ``scripts/perf_breakdown.py`` on the CPU: the same rows in the
same order, and the stage chain it times giving the entry point's
keypoints bit for bit.  Tolerance: none."""

from __future__ import annotations

import ast
import json
import pathlib

import pytest
import torch

import chip_smoke

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
BD = chip_smoke.port_script("torch_perf_breakdown")


def _jax_rows(batch: int) -> list[str]:
    """The names ``scripts/perf_breakdown.py`` passes to ``add`` on its
    front route (the TPU's: the ``if S._use_front(cfg)`` branch; its
    ``else`` is the non-front route), in source order, f-strings filled in
    with the batch."""
    tree = ast.parse((ROOT / "scripts" / "perf_breakdown.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    skip = set()
    for node in ast.walk(main):
        if isinstance(node, ast.If) and "_use_front" in ast.unparse(node.test):
            skip |= {id(n) for s in node.orelse for n in ast.walk(s)}
    names = []
    for node in ast.walk(main):  # breadth-first: re-sorted by position below
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "add" and id(node) not in skip):
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                text = arg.value
            else:
                text = "".join(v.value if isinstance(v, ast.Constant) else str(batch)
                               for v in arg.values)
            names.append(((node.lineno, node.col_offset), text))
    return [t for _, t in sorted(names)]


@pytest.mark.parametrize("batch", [2, 8])
def test_rows_equal_the_jax_scripts(batch):
    assert len(_jax_rows(batch)) == 18
    assert BD.jax_rows(batch) == _jax_rows(batch)


def test_main_on_the_cpu(capsys, tmp_path, monkeypatch):
    """``main(--device cpu --batch 2 --reps 1)`` on the pair's top-left 64 x
    96 pixels, one call a round (both patched in, to keep it short on the
    CPU): a line per row in the JAX script's order (the library rows beside
    the matcher's and the blur's), finite times; the stage chain's final
    keypoints bit-equal to ``detect_and_describe_batch`` on the same batch
    (the script exits 1 otherwise); the table and the last line."""
    frames, time_calls = BD.frames, BD.time_calls
    monkeypatch.setattr(BD, "frames", lambda b: frames(b)[:, :64, :96])
    monkeypatch.setattr(BD, "time_calls", lambda fn, reps: time_calls(fn, reps, calls=1))
    out = tmp_path / "breakdown.md"
    assert BD.main(["--device", "cpu", "--batch", "2", "--reps", "1", "--out", str(out)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    rows = [r for r in lines if "row" in r]
    assert [r["jax_row"] for r in rows if r["jax_row"]] == _jax_rows(2)
    assert [r["row"] for r in rows if r["jax_row"] is None] == [
        "match library cdist+topk (B/2 pairs, 8192^2)", "blur library conv2d (960x1280, s=1.6)",
        "blur library conv2d batch 2"]
    assert all(0 < r["min_ms"] <= r["median_ms"] < float("inf") for r in rows)
    summary = next(r for r in lines if "chain_equal_entry_point" in r)
    assert summary["chain_equal_entry_point"] is True
    assert summary["capacities"] == [8192, 4096, 8192] and summary["size"] == [64, 96]
    assert summary["route"] == "stacks"  # the entry point's route on the CPU
    stages = [r["median_ms"] for r in rows if not r["row"].startswith(("match ", "blur ", "alt "))]
    assert lines[-1] == {"stage_total_ms_median": sum(stages), "batch": 2}
    table = out.read_text().splitlines()
    assert table[0] == "# PERF — per-stage breakdown (cpu)" and table[3].startswith("reps=1;")
    assert "TPU" not in out.read_text()
    assert [ln.split(" | ")[0][2:] for ln in table[7:]] == [r["row"] for r in rows]
