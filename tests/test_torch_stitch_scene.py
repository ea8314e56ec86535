"""The stitching slice as a whole: the port's ``stitch_scene`` against the
JAX package's in the float64 profile on the CPU, and the port's ``python
-m sift_tpu_torch stitch`` command.

Three overlapping crops of the CAVE-01 frame 05 (``tests/data/
scene_oracle``) with a chain graph centred on the middle crop.  The JAX
side runs its XLA route (``use_pallas_pyramid=False``: the fused-front
route is not a descriptor reference, ROADMAP.md).  The float64 detections
of the two packages agree exactly, so only the RANSAC samples need
feeding: the port draws the JAX package's own indices here.  Each test
states its tolerance.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import sift_tpu.models.stitch as JS
import sift_tpu_torch.models.stitch as PS
from sift_tpu import SiftConfig as JaxConfig
from sift_tpu import detect_and_describe as jax_detect
from sift_tpu.utils.stitch_graph import StitchGraph as JaxGraph
from sift_tpu_torch import SiftConfig, cli, detect_and_describe
from sift_tpu_torch.utils.io import load_image
from sift_tpu_torch.utils.stitch_graph import StitchGraph, parse_stitch_graph

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
CAPS = dict(extrema_cap=1024, kp_cap=512, ori_cap=2048)
EDGES = ((0, 1), (1, 2))


@partial(jax.jit, static_argnums=(1,))
def jax_samples(valid, num_hypotheses, seed=0):
    """The (K, 4) indices the JAX package's ``ransac_homography`` draws
    (``sift_tpu/models/stitch.py:136-140``), from the same program."""
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return jax.random.choice(jax.random.PRNGKey(seed), valid.shape[0],
                             shape=(num_hypotheses, 4), replace=True, p=probs)


def fed_samples(valid, num_hypotheses, seed=0):
    idx = jax_samples(jnp.asarray(valid.cpu().numpy()), num_hypotheses, seed)
    return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(valid.device)


def crops(step=1):
    """Three crops of frame 05, 140 px apart (every ``step``-th pixel)."""
    tex = np.load(DATA / "scene_oracle" / "cave01_05.npz")["input"].astype(np.float32)
    return [tex[::step, a:a + 360:step] for a in (0, 140, 280)]


@pytest.fixture(scope="module")
def scene():
    """Both packages' float64 detections of the three crops."""
    imgs = crops()
    jcfg = JaxConfig(dtype=jnp.float64, use_pallas_pyramid=False, **CAPS)
    cfg = SiftConfig(dtype=torch.float64, **CAPS)
    return dict(
        imgs=imgs, jcfg=jcfg, cfg=cfg,
        jkps=[jax_detect(im, jcfg) for im in imgs],
        kps=[detect_and_describe(im, cfg, device="cpu") for im in imgs],
    )


def _corners(h, w=360, hh=480):
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, hh - 1, 1], [w - 1, hh - 1, 1]], float)
    q = c @ np.asarray(h).T
    return q[:, :2] / q[:, 2:]


def test_float64_detections_agree_exactly(scene):
    """Tolerance: none, every lane of every field, but pori to 1e-9 (libm's
    exp / atan2 against XLA's, tests/test_parity_stages.py's contract)."""
    for jk, pk in zip(scene["jkps"], scene["kps"]):
        got = pk.to_numpy()
        for f, v in got.items():
            want = np.asarray(getattr(jk, f))
            if f == "pori":
                np.testing.assert_allclose(v, want, rtol=0, atol=1e-9)
            else:
                np.testing.assert_array_equal(v, want, err_msg=f)
        assert 150 < got["valid"].sum() <= CAPS["ori_cap"]


def test_edge_homographies_match_jax(scene, monkeypatch):
    """Per tree edge, fed JAX's samples.  Tolerance: the four corners of
    each crop within 1e-6 px."""
    monkeypatch.setattr(PS, "sample_hypotheses", fed_samples)
    got = PS.solve_edge_homographies(scene["kps"], StitchGraph(1, 0.0, 3, EDGES), scene["cfg"])
    want = JS.solve_edge_homographies(scene["jkps"], JaxGraph(1, 0.0, 3, EDGES), scene["jcfg"])
    assert sorted(got) == sorted(want) == [(0, 1), (2, 1)]
    for e in want:
        np.testing.assert_allclose(_corners(got[e]), _corners(want[e]), rtol=0, atol=1e-6)
    # The crops are 140 px apart: each edge is that translation.
    np.testing.assert_allclose(_corners(got[(0, 1)]) - _corners(np.eye(3)), [[-140, 0]] * 4,
                               atol=0.5)


def test_stitch_scene_matches_jax(scene, monkeypatch):
    """The whole panorama (gains + multiband), fed JAX's samples.
    Tolerance: the same canvas; at least 99.9% of the pixels within 0.01
    grey levels, the rest counted (a seam can fall to the other image where
    two feather weights tie)."""
    monkeypatch.setattr(PS, "sample_hypotheses", fed_samples)
    got = PS.stitch_scene(scene["imgs"], StitchGraph(1, 0.0, 3, EDGES), scene["cfg"],
                          kps=scene["kps"], device="cpu")
    want = JS.stitch_scene(scene["imgs"], JaxGraph(1, 0.0, 3, EDGES), scene["jcfg"],
                           kps=scene["jkps"])
    assert got.shape == want.shape and got.shape[1] >= 620
    d = np.abs(got - want).max(-1)
    off = int((d > 0.01).sum())
    assert off <= 0.001 * d.size, f"{off} of {d.size} pixels off by more than 0.01"
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 255


def test_stitch_pair_matches_jax(scene, monkeypatch):
    """The two-image workflow on the first two crops (detection inside, the
    float64 profile), fed JAX's samples.  Tolerance: as the scene's."""
    monkeypatch.setattr(PS, "sample_hypotheses", fed_samples)
    a, b = scene["imgs"][:2]
    got = PS.stitch_pair(a, b, scene["cfg"], device="cpu")
    want = JS.stitch_pair(a, b, scene["jcfg"])
    assert got.shape == want.shape and got.shape[1] >= 490
    d = np.abs(got - want).max(-1)
    assert int((d > 0.01).sum()) <= 0.001 * d.size


GRAPH_FILE = """\
{ center_image_index | 1 | }
{ center_image_rotation_angle | 0.02 | radians }
{ images_count | 4 | one frame more than the directory holds }
{ matching_graph_image_edges-0 | 1 | }
{ matching_graph_image_edges-1 | 2 | }
{ matching_graph_image_edges-2 | 3 | }
"""


def test_cli_stitch_on_the_cpu_gives_the_library_pixels(tmp_path, capsys):
    """``stitch <dir> --device cpu`` with a STITCH-GRAPH file (declaring one
    image more than the directory holds, with a center rotation): the
    subset warning, the printed line, and the PNG of the library call's
    panorama (float32 on the CPU, default capacities; the crops at half
    resolution and 256 hypotheses, to keep the two runs short).
    Tolerance: none (uint8 pixels)."""
    scene_dir = tmp_path / "scene"
    scene_dir.mkdir()
    for i, im in enumerate(crops(step=2)):
        Image.fromarray(im.astype(np.uint8)).save(scene_dir / f"{i:02d}.png")
    (scene_dir / "scene-STITCH-GRAPH.txt").write_text(GRAPH_FILE)
    out = tmp_path / "pano.png"
    assert cli.main(["stitch", str(scene_dir), "--out", str(out), "--device", "cpu",
                     "--hypotheses", "256"]) == 0
    captured = capsys.readouterr()
    assert "warning" not in captured.err  # the default capacities hold these frames
    printed = captured.out.strip().splitlines()
    assert printed[0].startswith("warning: graph declares 4 images, found 3")
    got = np.asarray(Image.open(out))

    graph = parse_stitch_graph(scene_dir / "scene-STITCH-GRAPH.txt").subset(3)
    assert graph == StitchGraph(1, 0.02, 3, EDGES)
    imgs = [load_image(str(scene_dir / f"{i:02d}.png")) for i in range(3)]
    want = PS.stitch_scene(imgs, graph, SiftConfig(), num_hypotheses=256, device="cpu")
    assert printed[-1] == f"{out}: {want.shape[1]}x{want.shape[0]} from 3 images"
    np.testing.assert_array_equal(got, np.clip(want, 0, 255).astype(np.uint8))


def test_cli_stitch_warns_when_a_capacity_clips(tmp_path, capsys, monkeypatch):
    """With capacities too small for the frames, ``stitch`` names each frame
    whose detections were clipped, in the pair command's words, and still
    writes the panorama."""
    import sift_tpu_torch

    monkeypatch.setattr(sift_tpu_torch, "SiftConfig",
                        lambda: SiftConfig(extrema_cap=256, kp_cap=128, ori_cap=256))
    for i, im in enumerate(crops(step=2)):
        Image.fromarray(im.astype(np.uint8)).save(tmp_path / f"{i:02d}.png")
    out = tmp_path / "pano.png"
    assert cli.main(["stitch", str(tmp_path), "--out", str(out), "--device", "cpu",
                     "--hypotheses", "64"]) == 0
    err = capsys.readouterr().err
    for i in range(3):
        assert f"{i:02d}.png: warning: extrema count " in err
    assert out.is_file()


def test_cli_stitch_without_a_card_exits_2(tmp_path):
    """``python -m sift_tpu_torch stitch <dir>`` with neither a card nor
    ``--device cpu`` exits 2 with a message and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "00.png")
    out = tmp_path / "pano.png"
    proc = subprocess.run([sys.executable, "-m", "sift_tpu_torch", "stitch", str(tmp_path),
                           "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    assert not out.exists()
