"""The port's native runtime beyond the decoder: the threaded loader
(``utils/native.ImageLoader``), glibc's ``pow(2, x)`` (``pow2_glibc``) and
``models/sift.host_exact_sizes`` on it, and the library's two builds.

The loader is held to the npz inputs and to ``load_image`` on PNGs of
mixed sizes, in order, at 1, 3 and 8 threads; ``pow2_glibc`` to
``math.pow`` and to the JAX package's binding, bit for bit.
"""

from __future__ import annotations

import ctypes
import math
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import sift_tpu.utils.native as jax_native
from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.utils import native
from sift_tpu_torch.utils.io import load_image, save_image
from sift_tpu_torch.utils.keypoints import Keypoints
from test_torch_cli import _jax_native_built

DATA = Path(__file__).resolve().parent / "data"
SCENE = (0, 5, 12, 17, 26, 34)


def _why_no_library() -> str:
    if shutil.which("g++") is None:
        return "g++ is missing"
    return "libjpeg / libpng headers are missing (and no Pillow wheel codecs)"


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"the native library does not build here: {_why_no_library()}")
    return native


@pytest.fixture(scope="module")
def frames(tmp_path_factory, lib):
    """Eight PNGs, six 640x480 scene frames and small.png / medium.png in
    between, with the pixels each should decode to."""
    d = tmp_path_factory.mktemp("loader")
    paths, want = [], []
    for i in SCENE:
        a = np.load(DATA / "scene_oracle" / f"cave01_{i:02d}.npz")["input"]
        paths.append(str(d / f"cave01_{i:02d}.png"))
        save_image(paths[-1], a)
        want.append(a.astype(np.float32))
    for name in ("small", "medium"):
        paths.append(str(DATA / f"{name}.png"))
        want.append(load_image(paths[-1]))
    order = [0, 6, 1, 2, 7, 3, 4, 5]
    return [paths[i] for i in order], [want[i] for i in order]


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_loader_order_and_pixels(frames, threads):
    paths, want = frames
    with native.ImageLoader(paths, n_threads=threads) as loader:
        got = list(loader)
    assert len(got) == len(want)
    for i, (g, w, p) in enumerate(zip(got, want, paths)):
        assert g.dtype == np.float32 and g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
        np.testing.assert_array_equal(g, load_image(p), err_msg=f"frame {i} vs load_image")


def test_missing_file_raises_at_its_index(frames, tmp_path):
    paths, want = frames
    seq = paths[:2] + [str(tmp_path / "missing.png")] + paths[2:4]
    loader = native.ImageLoader(seq, n_threads=3)
    np.testing.assert_array_equal(next(loader), want[0])
    np.testing.assert_array_equal(next(loader), want[1])
    with pytest.raises(IOError, match="frame 2"):
        next(loader)
    rest = list(loader)
    assert len(rest) == 2
    np.testing.assert_array_equal(rest[0], want[2])
    np.testing.assert_array_equal(rest[1], want[3])
    loader.close()
    loader.close()
    with pytest.raises(ValueError, match="closed"):
        next(loader)


def test_close_joins_workers_blocked_on_a_full_queue(frames):
    """Workers wait once 8 decoded frames are queued; ``close`` stops and
    joins them though nothing was read."""
    paths, _ = frames
    loader = native.ImageLoader(paths * 4, n_threads=2)
    t = threading.Thread(target=loader.close)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()


def test_loader_raises_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.ImageLoader([str(DATA / "small.png")])
    assert native.pow2_glibc(np.zeros(3)) is None


def test_pow2_glibc_bit_equal(lib, monkeypatch):
    x = np.random.default_rng(13).uniform(-1.0, 3.0, 10_000)
    got = native.pow2_glibc(x)
    assert got.dtype == np.float64 and got.shape == x.shape
    want = np.array([math.pow(2, float(v)) for v in x])
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    if not _jax_native_built():
        pytest.skip(f"the JAX package's native library does not build: {_why_no_library()}")
    monkeypatch.setattr(jax_native, "_TRIED", False)
    monkeypatch.setattr(jax_native, "_LIB", None)
    ref = jax_native.pow2_glibc(x)
    np.testing.assert_array_equal(got.view(np.int64), ref.view(np.int64))
    grid = native.pow2_glibc(x.reshape(100, 100))
    np.testing.assert_array_equal(grid.reshape(-1), got)


def _float64_lanes(seed=5, batch=3, lanes=64):
    rng = np.random.default_rng(seed)
    shape = (batch, lanes)
    kp = Keypoints(
        x=torch.zeros(shape, dtype=torch.float64), y=torch.zeros(shape, dtype=torch.float64),
        octave=torch.from_numpy(rng.integers(0, 8, shape).astype(np.int32)),
        layer=torch.from_numpy(rng.integers(1, 4, shape).astype(np.int32)),
        size=torch.from_numpy(rng.uniform(1, 30, shape)),
        pori=torch.zeros(shape, dtype=torch.float64),
        desc=torch.zeros(shape + (128,), dtype=torch.uint8),
        valid=torch.from_numpy(rng.random(shape) < 0.7),
    )
    return kp, torch.from_numpy(rng.uniform(-0.5, 0.5, shape))


def test_host_exact_sizes_with_and_without_the_library(lib, monkeypatch):
    """The vectorised branch (the library's pow) and the per-lane loop give
    the same bits; invalid lanes keep their sizes."""
    cfg = SiftConfig(dtype=torch.float64)
    kp, off0 = _float64_lanes()
    fast = S.host_exact_sizes(kp, off0, cfg)
    monkeypatch.setattr(native, "pow2_glibc", lambda x: None)
    loop = S.host_exact_sizes(kp, off0, cfg)
    assert fast.size.dtype == torch.float64
    np.testing.assert_array_equal(fast.size.numpy().view(np.int64),
                                  loop.size.numpy().view(np.int64))
    v = kp.valid.numpy()
    np.testing.assert_array_equal(fast.size.numpy()[~v], kp.size.numpy()[~v])
    assert (fast.size.numpy()[v] != kp.size.numpy()[v]).all()


def test_builds_against_the_wheels_codecs(tmp_path, monkeypatch):
    """The second build (the headers of csrc/codecs, Pillow's bundled
    libjpeg / libpng) decodes PNG and JPEG as Pillow does; three threads
    building at once each get the whole library."""
    ways = native.recipes()[1:]
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing")
    if not ways:
        pytest.skip("Pillow's wheel bundles no libjpeg / libpng here")
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    out = [None] * 3
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, native._build(ways[0])))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert out[0] is not None and out == [out[0]] * 3
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [out[0].name]
    lib = ctypes.CDLL(str(out[0]))
    f = ctypes.POINTER(ctypes.c_float)
    i = ctypes.POINTER(ctypes.c_int)
    lib.sift_decode_image.argtypes = [ctypes.c_char_p, ctypes.POINTER(f), i, i, i]
    lib.sift_decode_image.restype = ctypes.c_int
    lib.sift_free.argtypes = [ctypes.c_void_p]
    img = np.load(DATA / "scene_oracle" / "cave01_05.npz")["input"]
    for name, kw in (("a.png", {}), ("a.jpg", {"quality": 90})):
        Image.fromarray(img).save(tmp_path / name, **kw)
        data = f()
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        assert lib.sift_decode_image(str(tmp_path / name).encode(), ctypes.byref(data),
                                     ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
        got = np.ctypeslib.as_array(data, shape=(h.value, w.value, c.value)).copy()
        lib.sift_free(data)
        np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / name)), err_msg=name)


def test_a_library_that_does_not_load_is_passed_over(tmp_path, monkeypatch, lib):
    """A library left by another machine (here: a file that is no library)
    under the first recipe's name does not stop the next recipe."""
    monkeypatch.setattr(native, "BUILD", tmp_path)
    ways = native.recipes()
    bogus = native._target(ways[0])
    bogus.write_bytes(b"not a shared object")
    fallback = ([], ["-ljpeg", "-lpng", "-lpthread", "-Wl,--as-needed"])
    monkeypatch.setattr(native, "recipes", lambda: [ways[0], fallback])
    monkeypatch.setattr(native, "_STATE", {})
    assert native.available()
    assert native._target(fallback).exists() and bogus.read_bytes() == b"not a shared object"
    np.testing.assert_array_equal(native.decode_image(str(DATA / "small.png")),
                                  load_image(str(DATA / "small.png")))
