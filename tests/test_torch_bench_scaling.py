"""The port's scaling harness (``scripts/torch_bench_scaling.py``), the
counterpart of ``scripts/bench_scaling.py``, on the CPU: ``--simulate 2``
(two gloo ranks) at 64 x 80, one frame a rank, one iteration.  Its frames'
keypoints are held against the JAX package's ``vmap(detect_fn)`` on the
same images, and its configuration and image draw against the values the
JAX script itself computes (its ``main`` run with the detector stubbed)."""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu.models.sift as jax_sift
from sift_tpu_torch.models.sift import detect_fn

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "torch_bench_scaling.py"
H, W = 64, 80


def _load():
    spec = importlib.util.spec_from_file_location("torch_bench_scaling", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SC = _load()


@pytest.fixture(scope="module")
def line():
    out = subprocess.run([sys.executable, str(SCRIPT), "--simulate", "2", "--size", str(H), str(W),
                          "--per-device-batch", "1", "--iters", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0])


def test_simulated_line_is_well_formed(line):
    """One line with the JAX script's ``mode`` and ``scaling`` rows
    (devices, frames_per_s, efficiency) at devices 1 and 2; nothing
    clipped; no kernel launches on the CPU."""
    assert line["mode"] == "simulated-cpu"
    assert [r["devices"] for r in line["scaling"]] == [1, 2]
    for r in line["scaling"]:
        assert {"devices", "frames_per_s", "efficiency"} <= set(r)
        assert r["frames_per_s"] > 0 and r["efficiency"] > 0
        assert len(r["keypoints"]) == len(r["keypoints_sha256"]) == r["devices"]
        assert set(r["launches"].values()) == {0}
    assert line["scaling"][0]["efficiency"] == 1.0
    assert line["clipped"] == []
    assert (line["size"], line["per_device_batch"], line["iters"]) == ([H, W], 1, 1)


def test_keypoints_equal_across_sizes_and_detect_fn(line):
    """Each frame's keypoints at world size 2 equal its keypoints at world
    size 1, and those equal single-process ``detect_fn``'s on the same
    image, bit for bit (SHA-256 of every field of the valid lanes)."""
    one, two = line["scaling"]
    assert two["keypoints_sha256"][0] == one["keypoints_sha256"][0]
    cfg = SC.config_for(H, W)
    octaves = cfg.octaves_count(2 * W, 2 * H)
    for f, img in enumerate(SC.images(2, H, W)):
        kp, counts = detect_fn(img, cfg, octaves, device="cpu", return_counts=True)
        assert SC.keypoints_digest(kp) == two["keypoints_sha256"][f]
        assert int(kp.valid.sum()) == two["keypoints"][f]
        assert int(counts["extrema"][0]) <= cfg.extrema_cap


def _jax_script_values(monkeypatch, h, w):
    """What ``scripts/bench_scaling.py`` computes at ``--simulate 2 --size
    h w --per-device-batch 1 --iters 1``, its detector stubbed: the
    configuration and octaves it hands ``detect_fn``, and the image batch
    of each mesh size, in order (sizes 1, 2, 4, ... up to the test's
    simulated devices).  JAX's backend starts first, so the script's
    ``XLA_FLAGS`` leave its device count as it is."""
    spec = importlib.util.spec_from_file_location("bench_scaling",
                                                  ROOT / "scripts" / "bench_scaling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen, batches = [], []
    put = jax.device_put

    def stub(im, cfg, octaves):
        seen.append((cfg, octaves))
        return im[0, 0, 0]

    def recording_put(x, *a, **k):
        batches.append(np.asarray(x))
        return put(x, *a, **k)

    jax.devices()
    monkeypatch.setattr(jax_sift, "detect_fn", stub)
    monkeypatch.setattr(jax, "device_put", recording_put)
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    monkeypatch.setattr(sys, "argv", ["bench_scaling.py", "--simulate", "2", "--size", str(h),
                                      str(w), "--per-device-batch", "1", "--iters", "1"])
    mod.main()
    monkeypatch.undo()
    assert len({(c, o) for c, o in seen}) == 1
    return seen[0][0], seen[0][1], batches


@pytest.mark.parametrize("size", [(H, W), (480, 640)], ids=["64x80", "480x640"])
def test_config_follows_the_jax_script(monkeypatch, capsys, size):
    """The capacities rule and octaves are the ones the JAX script computes
    (``bench_scaling.py:61-66``), in float32; the port's frames are the JAX
    script's stream of draws from ``default_rng(0)``: its size-1 batch is
    the port's first frame, and its batches of sizes 1, 2, 4, ... are, one
    after another, the port's first frames.  Unlike the JAX script, the
    port's size of N ranks takes the first N frames of that stream, so a
    frame is the same at every size.  Tolerance: none."""
    h, w = size
    jcfg, joct, batches = _jax_script_values(monkeypatch, h, w)
    cfg = SC.config_for(h, w)
    assert (cfg.extrema_cap, cfg.kp_cap, cfg.ori_cap) == (jcfg.extrema_cap, jcfg.kp_cap,
                                                          jcfg.ori_cap)
    assert cfg.dtype == torch.float32 and jcfg.dtype == jnp.float32
    assert cfg.octaves_count(2 * w, 2 * h) == joct
    sizes = SC.sizes_upto(len(jax.devices()))
    assert [len(b) for b in batches] == sizes and len(sizes) > 1
    np.testing.assert_array_equal(SC.images(sum(sizes), h, w), np.concatenate(batches))
    np.testing.assert_array_equal(SC.images(1, h, w), batches[0])
    assert SC.sizes_upto(1) == [1] and SC.sizes_upto(6) == [1, 2, 4]
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["mode"] == "simulated-cpu"


def test_keypoints_equal_jax_detect_fn(line, monkeypatch):
    """The harness's frames against the JAX script's own computation on
    them: ``jit(vmap(detect_fn))`` of the JAX package, at the configuration
    the JAX script builds, on the harness's images (``images(2, 64, 80)``).
    The same valid lanes (so each frame's count in the line), octave, layer
    and every descriptor byte; x, y and size within 1.25e-4 px and pori
    within 1e-5 rad (float32: the port's blur divides by the weights' sum,
    JAX's multiplies by its reciprocal).  The line's frames are bit-equal
    to the port's ``detect_fn`` (``test_keypoints_equal_across_sizes_and_
    detect_fn``), so this holds the harness's keypoints themselves."""
    jcfg, joct, _ = _jax_script_values(monkeypatch, H, W)
    imgs = SC.images(2, H, W)
    want = jax.jit(jax.vmap(lambda im: jax_sift.detect_fn(im, jcfg, joct)))(jnp.asarray(imgs))
    two = line["scaling"][1]
    cfg = SC.config_for(H, W)
    for f, img in enumerate(imgs):
        got = detect_fn(img, cfg, joct, device="cpu")
        assert SC.keypoints_digest(got) == two["keypoints_sha256"][f]
        v = np.asarray(want.valid[f])
        assert v.sum() == two["keypoints"][f] > 0
        np.testing.assert_array_equal(got.valid.numpy(), v)
        for k, tol in (("x", 1.25e-4), ("y", 1.25e-4), ("size", 1.25e-4), ("pori", 1e-5)):
            np.testing.assert_allclose(getattr(got, k).numpy()[v],
                                       np.asarray(getattr(want, k)[f])[v], rtol=0, atol=tol,
                                       err_msg=k)
        for k in ("octave", "layer", "desc"):
            np.testing.assert_array_equal(getattr(got, k).numpy()[v],
                                          np.asarray(getattr(want, k)[f])[v], err_msg=k)
