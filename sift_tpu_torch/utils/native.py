"""ctypes bindings to the repo's host runtime (``csrc/sift_tpu_native.cpp``).

The counterpart of ``sift_tpu/utils/native.py``: the libjpeg / libpng
decoder and the drawing rasterizers, a host codec and not a device kernel.
The port builds its own copy of the one source with g++ into
``sift_tpu_torch/_build/`` on first use (the hash of the source and the
flags names the library, so an edited source rebuilds); where the compiler
or the codecs' headers are missing, ``available()`` is False and the
callers take their Pillow / numpy paths, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "sift_tpu_native.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
LIBS = ["-ljpeg", "-lpng", "-lpthread"]

_LOCK = threading.Lock()
_STATE: dict[str, ctypes.CDLL | None] = {}

_F = ctypes.POINTER(ctypes.c_float)
_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)


def _build() -> Path | None:
    """The built library, compiling it if needed; None if it cannot be."""
    if not SOURCE.exists():
        return None
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS + LIBS).encode())
    so = BUILD / f"_native-{tag.hexdigest()[:12]}.so"
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp), *LIBS],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def _lib() -> ctypes.CDLL | None:
    with _LOCK:
        if "lib" in _STATE:
            return _STATE["lib"]
        so = _build()
        try:
            lib = ctypes.CDLL(str(so)) if so else None
        except OSError:
            lib = None
        if lib is not None:
            lib.sift_decode_image.restype = ctypes.c_int
            lib.sift_decode_image.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(_F), _I, _I, _I,
            ]
            lib.sift_free.restype = None
            lib.sift_free.argtypes = [ctypes.c_void_p]
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
    try:
        n = w.value * h.value * c.value
        return np.ctypeslib.as_array(data, shape=(n,)).astype(np.float32).reshape(
            h.value, w.value, c.value)
    finally:
        lib.sift_free(data)


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
