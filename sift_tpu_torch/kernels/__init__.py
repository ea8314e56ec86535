"""Build and load the hand-written CUDA kernels of ``sift_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled by
``nvcc`` into ``_build/lib<name>-<hash>.so`` on first use, then loaded with
ctypes (no PyTorch headers: a build takes seconds).  The hash covers the
source and the flags, so an edited source rebuilds.  Nothing here runs at
import time: the package imports on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

# -fmad=false: the blur chain must round each product and sum separately,
# like the plain PyTorch version (and IEEE '/' stays the default).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process or None, temp path, final path)."""
    src, so = _target(name)
    if so.exists():
        return None, None, so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, so


def build(names) -> dict[str, str]:
    """Compile the named sources in parallel (one nvcc each); returns each
    one's compiler output (ptxas register/shared-memory report)."""
    started = {n: _start_build(n) for n in names}
    logs = {}
    for n, (proc, tmp, so) in started.items():
        if proc is None:
            logs[n] = "cached"
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu:\n{out}")
        os.replace(tmp, so)
        logs[n] = out
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)[1]))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
