"""Checkpoint / resume for pipeline artifacts.

Counterpart of ``sift_tpu/utils/checkpoint.py``.  The reference recomputes
everything on every run (its only artifacts are terminal PNGs,
src/sift.cpp:768,875).  Here every stage output is persistable: keypoint
and descriptor buffers per image (npz, in the JAX package's layout, so a
file written by either package loads in the other), so matching,
stitching and SfM resume without re-detection, and BA state snapshots so
long optimizations restart mid-run.  Cache keys hash the image path, its
mtime and size, and the config, so stale entries invalidate themselves.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import zipfile

import numpy as np
import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.utils.keypoints import Keypoints
from sift_tpu_torch.utils.numerics import resolve_device


def save_keypoints(path: str, kp) -> None:
    """All lanes of a buffer (the port's Keypoints, or any object with the
    eight fields) as a compressed npz of x, y, octave, layer, size, pori,
    desc and valid."""
    arrays = kp.to_numpy() if isinstance(kp, Keypoints) else Keypoints.from_numpy(kp).to_numpy()
    np.savez_compressed(path, **arrays)


def load_keypoints(path: str, device="cuda") -> Keypoints:
    """A buffer saved by either package, on ``device``."""
    dev = resolve_device(device)
    with np.load(path) as d:
        return Keypoints.from_numpy(dict(d), device=dev)


def _cache_key(image_path: str, cfg: SiftConfig) -> str:
    st = os.stat(image_path)
    cfg_desc = json.dumps(
        {f.name: str(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}, sort_keys=True)
    h = hashlib.sha1(
        f"{os.path.abspath(image_path)}|{st.st_mtime_ns}|{st.st_size}|{cfg_desc}".encode())
    return h.hexdigest()[:20]


def cached_detect(image_path: str, cfg: SiftConfig | None = None,
                  cache_dir: str = ".sift_tpu_torch_cache", device="cuda") -> Keypoints:
    """``detect_and_describe`` with on-disk resume.

    The first call detects and persists; later calls (same file, mtime,
    size and config) load the checkpoint, so a crashed scene run resumes
    where it stopped.
    """
    from sift_tpu_torch.models.sift import detect_and_describe
    from sift_tpu_torch.utils.io import load_image

    dev = resolve_device(device)
    cfg = cfg or SiftConfig()
    cache = pathlib.Path(cache_dir)
    cache.mkdir(parents=True, exist_ok=True)
    entry = cache / f"kp_{_cache_key(image_path, cfg)}.npz"
    if entry.exists():
        try:
            return load_keypoints(str(entry), dev)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            # a torn or foreign file: detect anew
            entry.unlink(missing_ok=True)
    kp = detect_and_describe(load_image(image_path), cfg, device=dev)
    save_keypoints(str(entry), kp)
    return kp


def save_ba_state(path: str, cams, points, meta: dict | None = None) -> None:
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    np.savez_compressed(path, cams=host(cams), points=host(points), meta=json.dumps(meta or {}))


def load_ba_state(path: str):
    """(cams, points, meta) as numpy arrays and a dict."""
    with np.load(path, allow_pickle=False) as d:
        return d["cams"], d["points"], json.loads(str(d["meta"]))
