"""The port's ``utils/profiling.py`` and ``utils/debug.py`` against the JAX
package's: the same JSON from ``StageTimer`` and ``Metrics`` for the same
values, a trace file from ``trace_to`` on the CPU, ``checked`` and
``nan_debug`` raising where the JAX ``checked`` raises and nowhere else,
and ``assert_finite`` naming the leaf."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.utils import debug as jax_debug
from sift_tpu.utils import profiling as jax_profiling
from sift_tpu_torch.utils import profiling
from sift_tpu_torch.utils.debug import assert_finite, checked, nan_debug
from sift_tpu_torch.utils.keypoints import Keypoints


def run_timer(mod, monkeypatch):
    """Three stages on a clock that ticks 0.25 s a read."""
    ticks = iter(np.arange(0, 10, 0.25))
    monkeypatch.setattr(mod.time, "perf_counter", lambda: float(next(ticks)))
    t = mod.StageTimer()
    for name in ("describe", "blur", "blur"):
        with t.stage(name):
            pass
    return t


def test_stage_timer_summary_and_report_equal_jax(monkeypatch):
    got, want = run_timer(profiling, monkeypatch), run_timer(jax_profiling, monkeypatch)
    assert got.summary() == want.summary()
    assert got.report() == want.report()
    assert got.summary()["blur"] == {"total_s": 0.5, "calls": 2, "mean_ms": 250.0}


def test_metrics_json_equals_jax():
    got, want = profiling.Metrics(), jax_profiling.Metrics()
    for m in (got, want):
        m.set("fps", 100.0)
        m.set("keypoints", [677, 1067])
        m.set("backend", "gloo")
    assert got.to_json() == want.to_json()
    assert json.loads(got.to_json())["fps"] == 100.0


def test_stage_timer_syncs_only_with_a_result():
    t = profiling.StageTimer(sync=True)
    out = {"a": torch.ones(3), "kp": [torch.zeros(2)]}
    with t.stage("work", out):
        out["a"] = out["a"] * 2
    with t.stage("work"):
        pass
    assert t.summary()["work"]["calls"] == 2


def test_trace_to_writes_a_trace(tmp_path):
    t = profiling.StageTimer()
    with profiling.trace_to(str(tmp_path / "trace")) as prof:
        with t.stage("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "matmul" in names and any("mm" in str(n) for n in names)
    assert any(e.key == "matmul" for e in prof.key_averages())


CASES = {
    "clean": (lambda x: (x * 2.0 + 1.0).sum(), lambda: np.ones(4, np.float32)),
    "zero_by_zero": (lambda x: x / x, lambda: np.zeros(4, np.float32)),
    "out_of_bounds_gather": (lambda x: x[jnp.asarray([1, 5])] if isinstance(x, jnp.ndarray)
                             else x[torch.tensor([1, 5])], lambda: np.ones(4, np.float32)),
}


def raises(fn) -> bool:
    try:
        fn()
    except Exception:  # noqa: BLE001 -- which exception differs by package
        return True
    return False


@pytest.mark.parametrize("case", list(CASES))
def test_checked_raises_where_jax_checked_raises(case):
    fn, make = CASES[case]
    want = raises(lambda: jax_debug.checked(fn)(jnp.asarray(make())))
    got = raises(lambda: checked(fn)(torch.from_numpy(make())))
    assert got == want == (case != "clean")


def test_checked_raises_the_right_errors():
    with pytest.raises(FloatingPointError, match="div"):
        checked(CASES["zero_by_zero"][0])(torch.zeros(4))
    with pytest.raises(IndexError, match="out of bounds"):
        checked(CASES["out_of_bounds_gather"][0])(torch.ones(4))
    with pytest.raises(IndexError):
        checked(lambda x: torch.gather(x, 0, torch.tensor([0, 4])))(torch.ones(4))


def test_checked_passes_inf_it_was_given():
    """A sentinel built from inf (the dedup's sort keys) is not a fault."""
    f = checked(lambda x: torch.where(x > 0, x, torch.tensor(float("inf"))).amin())
    assert float(f(torch.tensor([-1.0, 2.0]))) == 2.0


def test_nan_debug_scope():
    with nan_debug():
        assert float((torch.ones(3) * 2).sum()) == 6.0
        with pytest.raises(FloatingPointError):
            torch.zeros(3) / torch.zeros(3)
        assert torch.ones(4)[torch.tensor([1])].item() == 1.0  # no index checks here
    assert torch.isnan(torch.zeros(1) / torch.zeros(1)).all()  # off again


def test_assert_finite_names_the_leaf():
    with pytest.raises(FloatingPointError, match=r"output\['a'\] contains"):
        assert_finite({"a": np.array([1.0, np.nan])})
    assert_finite({"a": np.array([1.0, 2.0]), "n": [np.arange(3)]})
    kp = Keypoints.from_numpy(dict(
        x=np.zeros(2), y=np.zeros(2), octave=np.zeros(2), layer=np.zeros(2),
        size=np.array([1.0, np.inf]), pori=np.zeros(2), desc=np.zeros((2, 128)),
        valid=np.ones(2, bool)))
    with pytest.raises(FloatingPointError, match=r"final\[1\]\.size contains"):
        assert_finite([None, kp], "final")
    with pytest.raises(FloatingPointError) as jax_err:
        jax_debug.assert_finite({"a": np.array([1.0, np.nan])})
    with pytest.raises(FloatingPointError) as port_err:
        assert_finite({"a": np.array([1.0, np.nan])})
    assert str(port_err.value) == str(jax_err.value)
