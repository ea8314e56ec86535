"""ctypes bindings to the repo's host runtime (``csrc/sift_tpu_native.cpp``).

The counterpart of ``sift_tpu/utils/native.py``: the libjpeg / libpng
decoder, the threaded prefetching loader (``ImageLoader``), glibc's
``pow(2, x)`` (``pow2_glibc``) and the drawing rasterizers -- host code,
not device kernels.  The port builds its own copy of the one source with
g++ into ``sift_tpu_torch/_build/`` on first use (the hash of the source
and the build's flags names the library, so an edited source rebuilds).
Two builds are tried in order: against the system's libjpeg / libpng,
then, where their development headers are missing, against the codec
libraries that Pillow's wheel bundles (``pillow.libs/``), with the
matching headers kept in ``csrc/codecs/`` (libjpeg-turbo's jpeg 6.2 ABI,
libpng 1.6).  Where neither builds, ``available()`` is False: the CLI's
``load_image`` and the rasterizers take their Pillow / numpy paths, as in
the JAX package, and ``ImageLoader`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "sift_tpu_native.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"
CODEC_HEADERS = Path(__file__).resolve().parents[1] / "csrc" / "codecs"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_LOCK = threading.Lock()
_STATE: dict[str, ctypes.CDLL | None] = {}

_F = ctypes.POINTER(ctypes.c_float)
_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)


def recipes() -> list[tuple[list[str], list[str]]]:
    """The ways to build, in order, each (compiler flags, link arguments):
    the system's codecs, then Pillow's bundled ones where its wheel has
    them (linked by path, found at run time through the rpath)."""
    out = [([], ["-ljpeg", "-lpng", "-lpthread"])]
    spec = importlib.util.find_spec("PIL")
    if spec is not None and spec.origin:
        libs = Path(spec.origin).resolve().parent.parent / "pillow.libs"
        jpeg = sorted(libs.glob("libjpeg-*.so.62*"))
        png = sorted(libs.glob("libpng16-*.so.16*"))
        if jpeg and png:
            out.append(([f"-I{CODEC_HEADERS}"],
                        [str(jpeg[0]), str(png[0]), "-lpthread", f"-Wl,-rpath,{libs}"]))
    return out


def _target(recipe) -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS + recipe[0] + recipe[1]).encode())
    return BUILD / f"_native-{tag.hexdigest()[:12]}.so"


def _build(way) -> Path | None:
    """The library of one recipe, compiling it if needed; None if it does
    not compile.

    g++ writes a file of this process and thread, renamed into place when
    complete, so a process that finds the library never opens a partial
    one, and two processes building at once each rename a whole file."""
    if not SOURCE.exists():
        return None
    so = _target(way)
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, *way[0], str(SOURCE), "-o", str(tmp), *way[1]],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def _lib() -> ctypes.CDLL | None:
    """The first recipe's library that builds and loads (a library built on
    another machine may not load here), bound; None if none does."""
    with _LOCK:
        if "lib" in _STATE:
            return _STATE["lib"]
        lib = None
        for way in recipes():
            so = _build(way)
            try:
                lib = ctypes.CDLL(str(so)) if so else None
            except OSError:
                lib = None
            if lib is not None:
                break
        if lib is not None:
            lib.sift_decode_image.restype = ctypes.c_int
            lib.sift_decode_image.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(_F), _I, _I, _I,
            ]
            lib.sift_free.restype = None
            lib.sift_free.argtypes = [ctypes.c_void_p]
            lib.sift_loader_create.restype = ctypes.c_void_p
            lib.sift_loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ]
            lib.sift_loader_next.restype = ctypes.c_int
            lib.sift_loader_next.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_F), _I, _I, _I,
            ]
            lib.sift_loader_destroy.restype = None
            lib.sift_loader_destroy.argtypes = [ctypes.c_void_p]
            lib.sift_pow2.restype = None
            lib.sift_pow2.argtypes = [_D, _D, ctypes.c_int]
            lib.sift_draw_keypoints.restype = None
            lib.sift_draw_keypoints.argtypes = [
                _F, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _D, _D, _I, _D, ctypes.c_int, ctypes.c_double,
            ]
            lib.sift_draw_match_lines.restype = None
            lib.sift_draw_match_lines.argtypes = [
                _F, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _D, _D, _D, _D, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
        _STATE["lib"] = lib
        return lib


def available() -> bool:
    return _lib() is not None


def _take(lib, data, w, h, c) -> np.ndarray:
    """Copy a decoded (H, W, C) float32 buffer out and free it."""
    try:
        n = w.value * h.value * c.value
        return np.ctypeslib.as_array(data, shape=(n,)).astype(np.float32).reshape(
            h.value, w.value, c.value)
    finally:
        lib.sift_free(data)


def decode_image(path: str) -> np.ndarray | None:
    """Native decode to (H, W, C) float32 in [0, 255]; None on failure."""
    lib = _lib()
    if lib is None:
        return None
    data = _F()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if not lib.sift_decode_image(os.fsencode(path), ctypes.byref(data), ctypes.byref(w),
                                 ctypes.byref(h), ctypes.byref(c)):
        return None
    return _take(lib, data, w, h, c)


class ImageLoader:
    """Threaded prefetching decoder (the C++ pool of ``sift_loader_*``).

    Iterates (H, W, C) float32 frames in [0, 255] in the order of
    ``paths`` while ``n_threads`` worker threads decode ahead (a worker
    waits while max(8, 2 * n_threads) frames are queued).  ctypes releases the
    interpreter lock while a call waits for its frame, so decoding runs
    beside Python and the device.  A frame that does not decode raises
    ``IOError`` at its own position; the frames after it still come.
    Raises ``RuntimeError`` at construction when the library does not
    build: there is no other decoder behind it.  ``close()`` (also on
    leaving a ``with`` block, and at garbage collection) stops and joins
    the workers; a second call does nothing.
    """

    def __init__(self, paths, n_threads: int = 4):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native library unavailable: csrc/sift_tpu_native.cpp "
                               "does not build here (g++ and libjpeg / libpng needed)")
        if n_threads < 1:
            raise ValueError(f"n_threads must be at least 1, got {n_threads}")
        self._lib = lib
        self._paths = [os.fspath(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*(os.fsencode(p) for p in self._paths))
        self._handle = lib.sift_loader_create(arr, len(self._paths), n_threads)
        self._emitted = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise ValueError("ImageLoader is closed")
        if self._emitted >= len(self._paths):
            raise StopIteration
        data = _F()
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        ok = self._lib.sift_loader_next(self._handle, ctypes.byref(data), ctypes.byref(w),
                                        ctypes.byref(h), ctypes.byref(c))
        i = self._emitted
        self._emitted += 1
        if not ok:
            raise IOError(f"decode failed: frame {i} ({self._paths[i]})")
        return _take(self._lib, data, w, h, c)

    def close(self) -> None:
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.sift_loader_destroy(handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def pow2_glibc(x) -> np.ndarray | None:
    """Elementwise glibc ``pow(2, x)`` in float64, bit-equal to Python's
    ``math.pow(2, .)`` (both call libm; ``np.power`` rounds differently on
    some inputs); None without the library."""
    lib = _lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float64)
    if x.size >= 2**31:
        raise ValueError(f"pow2_glibc: {x.size} elements do not fit a C int")
    out = np.empty_like(x)
    lib.sift_pow2(x.ctypes.data_as(_D), out.ctypes.data_as(_D), x.size)
    return out


def _doubles(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


def draw_keypoints_native(img: np.ndarray, kps: dict, scales_count: float):
    """Keypoint overlay on ``img`` as float32 (in place if it is one
    already); None without the library."""
    lib = _lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    xs, ys, poris = _doubles(kps["x"]), _doubles(kps["y"]), _doubles(kps["pori"])
    layers = np.ascontiguousarray(kps["layer"], np.int32)
    if not len(xs) == len(ys) == len(layers) == len(poris):
        raise ValueError("keypoint fields of different lengths")
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    lib.sift_draw_keypoints(
        img.ctypes.data_as(_F), w, h, c, xs.ctypes.data_as(_D), ys.ctypes.data_as(_D),
        layers.ctypes.data_as(_I), poris.ctypes.data_as(_D), len(xs), float(scales_count))
    return img


def draw_match_lines_native(img: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                            x_offset: int, color: int = 0xFFFFFF):
    """One line per match on ``img`` as float32 (in place if it is one
    already); None without the library."""
    lib = _lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    if p1.shape != p2.shape or p1.ndim != 2 or p1.shape[1] != 2:
        raise ValueError(f"match endpoints of shapes {p1.shape} and {p2.shape}")
    x1, y1, x2, y2 = (_doubles(a) for a in (p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]))
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    lib.sift_draw_match_lines(
        img.ctypes.data_as(_F), w, h, c, x1.ctypes.data_as(_D), y1.ctypes.data_as(_D),
        x2.ctypes.data_as(_D), y2.ctypes.data_as(_D), len(x1), x_offset, color)
    return img
