"""The matcher sweep (``scripts/torch_bench_match_ab.py``) against the JAX
package's ``scripts/bench_match_ab.py`` on the CPU: the same descriptor
draws in the same order, and at n = 256 the port's paths against the JAX
package's ``match_descriptors`` and ``match_descriptors_pallas`` (interpret
mode).  Tolerance: none anywhere (the distances are exact integers)."""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sift_tpu.models.match as JM
import sift_tpu.ops.pallas_match as JP

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
MAB = chip_smoke.port_script("torch_bench_match_ab")


def _jax_script():
    spec = importlib.util.spec_from_file_location("bench_match_ab",
                                                  ROOT / "scripts" / "bench_match_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_draws_equal_the_jax_scripts(monkeypatch, capsys):
    """The JAX script's own ``main`` (its matchers stubbed, its cache
    settings held off, one rep) draws from ``np.random.default_rng`` exactly
    the arrays the port's ``draws`` yields, in the same order: two sets a
    size, then two at 4096."""
    sizes = [256, 512]
    drawn = []
    real = np.random.default_rng

    class Recorder:
        def __init__(self, seed=None):
            self.g = real(seed)

        def integers(self, *a, **kw):
            out = self.g.integers(*a, **kw)
            drawn.append(out)
            return out

    def stub(d1, v1, d2, v2, ratio=0.75, **kw):
        z = jnp.zeros(d1.shape[:1], jnp.int32)
        return z, z > 0, z, z

    monkeypatch.setattr(np.random, "default_rng", Recorder)
    monkeypatch.setattr(JM, "match_descriptors", stub)
    monkeypatch.setattr(JP, "match_descriptors_pallas", stub)
    monkeypatch.setattr(os, "makedirs", lambda *a, **kw: None)
    monkeypatch.setattr(jax.config, "update", lambda *a, **kw: None)
    monkeypatch.setattr(sys, "argv", ["bench_match_ab.py", "--reps", "1", "--sizes",
                                      *map(str, sizes)])
    _jax_script().main()
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {"agreement_4096": True}
    monkeypatch.undo()
    mine = [d for _, d1, d2 in MAB.draws(sizes) for d in (d1, d2)]
    assert [d.shape for d in mine] == [(n, 128) for n in (256, 256, 512, 512, 4096, 4096)]
    assert len(drawn) == len(mine)
    for a, b in zip(drawn, mine):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_paths_equal_the_jax_matchers_at_256():
    """n = 256, the script's first draws: the port's ``plain`` and
    ``kernel`` paths (the kernel's plain version on the CPU) give the JAX
    package's ``match_descriptors`` and ``match_descriptors_pallas`` (in
    interpret mode) idx, accept, best and second; the library path the
    same two nearest distances."""
    _, d1, d2 = next(MAB.draws([256]))
    fns = MAB.paths(d1, d2, torch.device("cpu"))
    plain, kernel = fns["plain"](), fns["kernel"]()
    v = jnp.ones((256,), bool)
    with jax.enable_x64(False):
        want = JM.match_descriptors(jnp.asarray(d1), v, jnp.asarray(d2), v, 0.75)
        pallas = JP.match_descriptors_pallas(jnp.asarray(d1), v, jnp.asarray(d2), v, 0.75,
                                             interpret=True)
    for name, p, k, w, q in zip(("idx", "accept", "best", "second"), plain, kernel, want, pallas):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(k.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(np.asarray(q), np.asarray(w), err_msg=name)
    lib = fns["library"]()
    np.testing.assert_array_equal((lib.values.double() ** 2).round().numpy(),
                                  torch.stack([plain[2], plain[3]], -1).double().numpy())


def test_main_on_the_cpu(capsys):
    """``main(--device cpu)``: a header, the three paths at each size, the
    bound line (``chip_smoke.top2_bound``), the agreement at every size and
    at 4096, exit 0."""
    assert MAB.main(["--device", "cpu", "--sizes", "256", "--reps", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["device"] == "cpu" and lines[0]["sizes"] == [256]
    assert [(r["n"], r["path"]) for r in lines if "path" in r] == [
        (256, "kernel"), (256, "plain"), (256, "library")]
    for r in lines:
        if "path" in r:
            assert 0 < r["min_ms"] <= r["median_ms"] and r["tflops_at_min"] > 0
    bound = next(r for r in lines if "bound_ms" in r)
    assert (bound["bound_ms"], bound["bound_by"]) == chip_smoke.bound(
        *chip_smoke.top2_bound(1, 256, 256))
    assert lines[-1] == {"agreement": {"256": True, "4096": True}, "agreement_4096": True}


def test_out_of_memory_is_a_datapoint_only_off_the_kernel_path(monkeypatch, capsys):
    """A ``library`` path that runs out of the card's memory is a line with
    its error; the same of the ``kernel`` path ends the run."""
    real = MAB.paths

    def paths(d1, d2, dev, fail="library"):
        fns = real(d1, d2, dev)

        def oom():
            raise torch.OutOfMemoryError("CUDA out of memory (planted)")
        fns[fail] = oom
        return fns

    monkeypatch.setattr(MAB, "paths", paths)
    assert MAB.main(["--device", "cpu", "--sizes", "256", "--reps", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    err = [r for r in lines if "error" in r]
    assert [(r["n"], r["path"]) for r in err] == [(256, "library")]
    assert err[0]["error"].startswith("OutOfMemoryError")
    monkeypatch.setattr(MAB, "paths", lambda d1, d2, dev: paths(d1, d2, dev, "kernel"))
    with pytest.raises(torch.OutOfMemoryError):
        MAB.main(["--device", "cpu", "--sizes", "256", "--reps", "1"])
