"""The port's SfM harness (``scripts/torch_sfm_eval.py``) as a command:
``--out`` and its table in SFM.md's format.  Its renderer, sequences and
metrics are held against the JAX package's, and its 6-frame sequence is
run through ``run_sfm`` on the CPU, in ``tests/test_torch_sfm_images.py``."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT = _load("torch_sfm_eval")


def test_out_writes_only_the_named_file(tmp_path, monkeypatch, capsys):
    """``--out FILE`` appends SFM.md's table of the four sequences to FILE
    and writes nothing else (SFM.md stays as it is); without ``--out`` the
    run writes no file.  The sequences' records are stubbed: this checks
    the command, not the SfM."""
    def fake(name, frames, gt, cfg, device, loop_closure=True):
        return dict(seq=name, frames=len(frames), ate_rmse_m=0.01, rpe_rmse_m=0.002,
                    path_m=1.6, ate_pct_of_path=0.625, seconds=1.25, registered=len(frames),
                    points=100, obs=400, pruned=3, launches={})

    monkeypatch.setattr(PORT, "evaluate", fake)
    monkeypatch.chdir(tmp_path)
    sfm_md = hashlib.sha256((ROOT / "SFM.md").read_bytes()).hexdigest()
    out = tmp_path / "table.md"
    assert PORT.main(["--device", "cpu", "--frames", "6", "--out", str(out)]) == 0
    assert PORT.main(["--device", "cpu", "--frames", "6"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["table.md"]
    assert hashlib.sha256((ROOT / "SFM.md").read_bytes()).hexdigest() == sfm_md
    lines = out.read_text().splitlines()
    assert lines[1].startswith("## Recorded run (") and lines[1].endswith("sift_tpu_torch, cpu)")
    assert lines[3] == ("| sequence | frames | ATE-RMSE | % of path | RPE-RMSE | points | obs "
                        "| pruned | seconds |")
    assert lines[5:] == [f"| {n} | {f} | 1.00 cm | 0.62% | 0.20 cm | 100 | 400 | 3 | 1.2 |"
                         for n, f in (("sweep-6", 6), ("loop-7", 7), ("bigloop-10", 10),
                                      ("bigloop-10-noclosure", 10))]
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [r["seq"] for r in recs[:4]] == ["sweep-6", "loop-7", "bigloop-10",
                                            "bigloop-10-noclosure"]
