"""Build and load the hand-written CUDA kernels of ``sift_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled by
``nvcc`` into ``_build/lib<name>-<hash>.so`` on first use, then loaded with
ctypes (no PyTorch headers: a build takes seconds).  The hash covers the
source and the flags, so an edited source rebuilds.  Nothing here runs at
import time: the package imports on machines without ``nvcc`` or a card.

Every wrapper passes its launch's status to ``check``, which also counts
the launches of the hand-written kernels (``launch_counts``).
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

# The hand-written kernels by the name their wrappers pass to ``check``:
# A, B, C, D, E, F, G, H, I, J.
_LAUNCHES = dict.fromkeys(
    ("octave_front", "top2", "octave_blur", "blur_pass", "twin_rows", "octave_front_twin",
     "cube_pack", "twin_rows_2d", "describe", "detect"), 0)


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
    """The loaded library of ``csrc/<name>.cu``, built on first use.  A
    build starts every source whose library is missing, in parallel, so
    that a process pays for its builds once, at its first kernel."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(sorted({name} | {p.stem for p in CSRC.glob("*.cu")
                                   if not _target(p.stem)[1].exists()}))
            lib = ctypes.CDLL(str(_target(name)[1]))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a failed launch; else count it if ``what`` names a
    hand-written kernel (a helper call such as ``blur_plan`` is no launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
    if what in _LAUNCHES:
        _LAUNCHES[what] += 1


def launch_counts() -> dict[str, int]:
    """Each hand-written kernel's successful launches in this process since
    the last ``reset_launch_counts``."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Zero every kernel's count."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
