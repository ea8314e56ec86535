"""The port's ``utils/checkpoint.py`` against the JAX package's: keypoint
files and BA state written by either package load in the other, and
``cached_detect`` on the CPU loads its second call without detecting and
misses after a new mtime or another config."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.utils import checkpoint as jax_ckpt
from sift_tpu.utils.keypoints import Keypoints as JaxKeypoints
from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.utils import checkpoint as ckpt
from sift_tpu_torch.utils.io import save_image
from sift_tpu_torch.utils.keypoints import FIELDS, Keypoints


def lanes(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.uniform(0, 640, n).astype(np.float32), y=rng.uniform(0, 480, n).astype(np.float32),
        octave=rng.integers(0, 8, n).astype(np.int32), layer=rng.integers(1, 4, n).astype(np.int32),
        size=rng.uniform(1, 30, n).astype(np.float32),
        pori=rng.uniform(0, 6.28, n).astype(np.float32),
        desc=rng.integers(0, 256, (n, 128)).astype(np.uint8), valid=rng.random(n) > 0.3)


def test_port_file_loads_in_the_jax_package(tmp_path):
    want = lanes()
    ckpt.save_keypoints(str(tmp_path / "kp.npz"), Keypoints.from_numpy(want))
    got = jax_ckpt.load_keypoints(str(tmp_path / "kp.npz"))
    for f in FIELDS:
        a = np.asarray(getattr(got, f))
        assert a.dtype == want[f].dtype, f
        np.testing.assert_array_equal(a, want[f], err_msg=f)
    assert int(got.count()) == int(want["valid"].sum())


def test_jax_file_loads_in_the_port(tmp_path):
    want = lanes(seed=1)
    jkp = JaxKeypoints(**{f: jnp.asarray(v) for f, v in want.items()})
    jax_ckpt.save_keypoints(str(tmp_path / "kp.npz"), jkp)
    got = ckpt.load_keypoints(str(tmp_path / "kp.npz"), device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f], err_msg=f)


def test_jax_keypoints_save_through_the_port(tmp_path):
    """The port's save takes any object with the eight fields."""
    want = lanes(seed=2)
    ckpt.save_keypoints(str(tmp_path / "kp.npz"),
                        JaxKeypoints(**{f: jnp.asarray(v) for f, v in want.items()}))
    got = ckpt.load_keypoints(str(tmp_path / "kp.npz"), device="cpu")
    np.testing.assert_array_equal(got.desc.numpy(), want["desc"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ba_state_round_trip_across_packages(tmp_path, writer):
    cams = np.arange(18, dtype=np.float64).reshape(3, 6)
    pts = np.linspace(-1, 1, 15).reshape(5, 3)
    save, load = ((ckpt.save_ba_state, jax_ckpt.load_ba_state) if writer == "port"
                  else (jax_ckpt.save_ba_state, ckpt.load_ba_state))
    arg = torch.from_numpy(cams) if writer == "port" else cams
    save(str(tmp_path / "ba.npz"), arg, pts, {"iter": 7, "lam": 1e-3})
    c, p, meta = load(str(tmp_path / "ba.npz"))
    np.testing.assert_array_equal(c, cams)
    np.testing.assert_array_equal(p, pts)
    assert meta == {"iter": 7, "lam": 1e-3}


@pytest.fixture
def image(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "img.png"
    save_image(str(path), rng.integers(0, 256, (48, 64, 3)).astype(np.float64))
    return path


def test_cached_detect_resumes_and_invalidates(tmp_path, image, monkeypatch):
    calls = []
    detect = S.detect_and_describe

    def counted(*a, **k):
        calls.append(1)
        return detect(*a, **k)

    monkeypatch.setattr(S, "detect_and_describe", counted)
    cfg = SiftConfig(extrema_cap=256, kp_cap=128, ori_cap=512)
    cache = str(tmp_path / "cache")
    kp1 = ckpt.cached_detect(str(image), cfg, cache_dir=cache, device="cpu")
    assert len(calls) == 1 and len(os.listdir(cache)) == 1
    kp2 = ckpt.cached_detect(str(image), cfg, cache_dir=cache, device="cpu")
    assert len(calls) == 1  # loaded, not detected
    for f in FIELDS:
        assert torch.equal(getattr(kp1, f), getattr(kp2, f)), f
    st = os.stat(image)
    os.utime(image, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    ckpt.cached_detect(str(image), cfg, cache_dir=cache, device="cpu")
    assert len(calls) == 2  # a new mtime misses
    ckpt.cached_detect(str(image), SiftConfig(extrema_cap=256, kp_cap=64, ori_cap=512),
                       cache_dir=cache, device="cpu")
    assert len(calls) == 3 and len(os.listdir(cache)) == 3  # so does another config


def test_cached_detect_replaces_a_torn_entry(tmp_path, image):
    cfg = SiftConfig(extrema_cap=256, kp_cap=128, ori_cap=512)
    cache = tmp_path / "cache"
    kp1 = ckpt.cached_detect(str(image), cfg, cache_dir=str(cache), device="cpu")
    (entry,) = cache.iterdir()
    entry.write_bytes(b"not an npz")
    kp2 = ckpt.cached_detect(str(image), cfg, cache_dir=str(cache), device="cpu")
    assert torch.equal(kp1.desc, kp2.desc)
    assert ckpt.load_keypoints(str(entry), device="cpu").desc.shape == kp1.desc.shape
