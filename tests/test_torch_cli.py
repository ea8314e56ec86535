"""The port's pair CLI and its host utilities against the JAX package's.

``python -m sift_tpu_torch a b`` (``sift_tpu_torch/cli.py``) with
``utils/io``, ``utils/draw`` and ``utils/native``: the same decoded pixels,
the same drawings byte for byte, the same JSON summary as ``python -m
sift_tpu``, and no silent CPU run without a card.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import sift_tpu
import sift_tpu.cli as jax_cli
import sift_tpu.utils.draw as jax_draw
import sift_tpu.utils.io as jax_io
import sift_tpu.utils.native as jax_native
import sift_tpu_torch
from sift_tpu import SiftConfig as JaxConfig
from sift_tpu_torch import SiftConfig, cli
from sift_tpu_torch.utils import draw, native
from sift_tpu_torch.utils import io as port_io

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"


def _jax_native_built() -> bool:
    """The JAX package's library, ``sift_tpu/_native.so``, complete on disk.

    Its loader runs ``make -C csrc`` when the file is missing and keeps the
    outcome for the life of the process; the Makefile links straight into
    the target, so a test worker that looks while another worker's linker
    is writing it finds a file that exists but does not load ("file too
    short", "invalid ELF header") and takes the library as absent for the
    rest of its run.  Here one worker at a time, under a lock, keeps a
    library that loads or builds one beside it and renames it into place.
    """
    so = ROOT / "sift_tpu" / "_native.so"
    build = ROOT / "sift_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    with open(build / "jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            try:
                ctypes.CDLL(str(so))
                return True
            except OSError:
                pass
        tmp = build / f"jax_native.{os.getpid()}.so"
        try:
            subprocess.run(["make", "-C", str(ROOT / "csrc"), f"TARGET={tmp}"], check=True,
                           capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, so)
        return True


def _native(monkeypatch, on: bool):
    """Both packages on their native decoder / rasterizer, or both on the
    Pillow / numpy paths.  The JAX package's loader is asked afresh, after
    ``_jax_native_built``, so that a failed first attempt of this worker
    (see there) does not decide."""
    if on:
        if _jax_native_built():
            monkeypatch.setattr(jax_native, "_TRIED", False)
            monkeypatch.setattr(jax_native, "_LIB", None)
        if not (native.available() and jax_native.available()):
            pytest.skip("the native library does not build here (g++, libjpeg, libpng)")
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "pillow"])
@pytest.mark.parametrize("kind", ["rgb.png", "rgba.png", "gray.png", "rgb.jpg"])
def test_load_image_agrees_with_jax(tmp_path, monkeypatch, kind, native_on):
    """Exactly the same float32 (H, W, C) array, alpha dropped.
    Tolerance: none."""
    _native(monkeypatch, native_on)
    rng = np.random.default_rng(3)
    mode = kind.split(".")[0].upper().replace("GRAY", "L")
    shape = (37, 53) if mode == "L" else (37, 53, len(mode))
    path = str(tmp_path / kind)
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(path)
    got, want = port_io.load_image(path), jax_io.load_image(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.shape[2] in (1, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "python"])
def test_draw_agrees_with_jax(monkeypatch, native_on):
    """draw_keypoints and draw_matches give the JAX package's arrays byte
    for byte on the same keypoints and pairs.  Tolerance: none."""
    _native(monkeypatch, native_on)
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (48, 64, 3))
    n = 25
    kps = dict(x=rng.uniform(-5, 70, n), y=rng.uniform(-5, 52, n),
               layer=rng.integers(0, 6, n).astype(np.int32), pori=rng.uniform(0, 6.28, n))
    got, want = draw.draw_keypoints(img, kps, 6), jax_draw.draw_keypoints(img, kps, 6)
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()
    gray = rng.uniform(0, 255, (40, 30))
    pairs = [((float(a), float(b)), (float(c), float(d)))
             for a, b, c, d in rng.uniform(0, 30, (12, 4))]
    got, want = draw.draw_matches(img, gray, pairs), jax_draw.draw_matches(img, gray, pairs)
    assert got.shape == (48, 94, 3)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """oracle_small's frame and the same frame shifted by 3 columns, as PNG."""
    d = tmp_path_factory.mktemp("pair")
    img = dict(np.load(DATA / "oracle_small.npz"))["input"]
    paths = [str(d / "a.png"), str(d / "b.png")]
    port_io.save_image(paths[0], img)
    port_io.save_image(paths[1], np.roll(img, 3, axis=1))
    return paths


def _summary(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_f64_cli_gives_the_jax_cli_summary_and_drawings(pair, tmp_path, capsys, monkeypatch):
    """``--f64`` runs the float64 parity profile on the CPU: the same
    keypoint and match counts as ``sift_tpu.cli.main`` and the same three
    PNGs.  Tolerance: none.  Both CLIs run at capacities 512 / 256 / 512
    (the frames have a handful of keypoints): the JAX package computes
    every capacity lane, 35 s a run at the defaults."""
    caps = dict(extrema_cap=512, kp_cap=256, ori_cap=512)
    monkeypatch.setattr(sift_tpu, "SiftConfig", functools.partial(JaxConfig, **caps))
    monkeypatch.setattr(sift_tpu_torch, "SiftConfig", functools.partial(SiftConfig, **caps))
    assert cli.main([*pair, "--f64", "--json", "--device", "cpu",
                     "--out-dir", str(tmp_path / "port")]) == 0
    got = _summary(capsys.readouterr().out)
    assert jax_cli.main([*pair, "--f64", "--json", "--out-dir", str(tmp_path / "jax")]) == 0
    want = _summary(capsys.readouterr().out)
    assert set(got) == set(want) == {"keypoints1", "keypoints2", "matches", "seconds"}
    assert [got[k] for k in ("keypoints1", "keypoints2", "matches")] == [
        want[k] for k in ("keypoints1", "keypoints2", "matches")]
    assert got["keypoints1"] > 0 and got["matches"] > 0
    for name in ("keypoints1.png", "keypoints2.png", "matches.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                      np.asarray(Image.open(tmp_path / "jax" / name)))


def test_module_entry_point_on_the_cpu(pair, tmp_path):
    """``python -m sift_tpu_torch a b --device cpu --json``: exit 0, the
    JSON summary as the last line, the three PNGs written."""
    out = subprocess.run(
        [sys.executable, "-m", "sift_tpu_torch", *pair, "--device", "cpu", "--json",
         "--out-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    summary = _summary(out.stdout)
    assert summary["keypoints1"] > 0 and summary["matches"] >= 0
    for name in ("keypoints1.png", "keypoints2.png", "matches.png"):
        assert (tmp_path / name).is_file()


def test_no_card_fails_unless_the_cpu_is_asked_for(pair, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    assert cli.main([*pair, "--json", "--out-dir", str(tmp_path)]) == 2
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and err.out == ""
    assert not (tmp_path / "matches.png").exists()
    with pytest.raises(SystemExit) as e:
        cli.main([*pair, "--f64", "--device", "cuda"])
    assert e.value.code == 2


def test_stitch_is_refused_until_ported(capsys):
    """``stitch`` is ported: it is refused only without a card and without
    ``--device cpu`` (exit 2, a message naming ``--device cpu``)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    assert cli.main(["stitch", "scene_dir"]) == 2
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and "--device cpu" in err.err and err.out == ""


def test_capacity_warning_matches_jax(capsys):
    """The same warnings as the JAX CLI's for the same true counts, read
    against the port's own Newton phase caps and candidate slots."""
    counts = dict(extrema=np.array([9000, 10]), refined=np.array([5000, 10]),
                  oriented=np.array([10, 8193]), ori_slots_max=np.array(9),
                  refine_active=np.array([[2049, 1024], [10, 1025]]))
    cli._warn_capacity_overflow({k: torch.from_numpy(v) for k, v in counts.items()},
                                SiftConfig())
    got = capsys.readouterr().err
    jax_cli._warn_capacity_overflow(counts, JaxConfig())
    want = capsys.readouterr().err
    assert got == want and got.count("warning:") == 6
