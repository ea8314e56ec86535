"""The port stands alone: no JAX, no sift_tpu, and CUDA by default."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import sift_tpu_torch
from sift_tpu_torch import (
    SiftConfig,
    detect_and_describe,
    detect_and_describe_batch,
    match_descriptors,
)
from sift_tpu_torch.models.sift import detect_stages

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sift_tpu_torch"


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


# The port's scripts that run on the card beside chip_smoke.py.
PORT_SCRIPTS = ["ab_blur_top2.py", "ab_cube_pack.py", "ab_twin_rows.py", "tune_octave_front.py",
                "torch_parallel_match.py", "torch_scene_throughput.py", "torch_stream_breakdown.py"]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + [ROOT / "scripts" / name for name in PORT_SCRIPTS],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_sift_tpu_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "sift_tpu"), f"{path.name} imports {mod}"


def test_fresh_import_leaves_jax_out():
    code = "import sys, sift_tpu_torch; print('jax' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_tf32_off():
    assert sift_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    img = np.zeros((32, 48), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_and_describe_batch(img[None])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_and_describe(img)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_stages(img, SiftConfig(), 2)
    d = np.zeros((4, 128), np.uint8)
    v = np.ones(4, bool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        match_descriptors(d, v, d, v)


def test_stitching_entry_points_default_to_cuda():
    """Every stitching function that takes a device defaults to the card,
    and without one ``stitch_scene`` and ``multiband_blend`` raise instead
    of running on the CPU."""
    import inspect

    from sift_tpu_torch.models import blend, cylindrical, stitch
    from sift_tpu_torch.utils.stitch_graph import chain_graph

    fns = [stitch.stitch_scene, stitch.stitch_pair, stitch.compose_scene, stitch.composite,
           stitch.blend_warped, blend.multiband_blend, blend.estimate_gains,
           blend.overlap_consistency, cylindrical.stitch_scene_cylindrical]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    img = np.zeros((32, 48, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stitch.stitch_scene([img, img], chain_graph(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blend.multiband_blend([img, img], [np.eye(3), np.eye(3)])


@pytest.mark.parametrize("module", ["geometry", "ba", "sfm"])
def test_sfm_slice_modules_stand_alone(module):
    """The SfM slice's modules exist in the port and import neither JAX nor
    the JAX package, directly or through what they import."""
    path = PKG / "models" / f"{module}.py"
    assert path.is_file()
    code = (f"import sys, sift_tpu_torch.models.{module}; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sift_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sfm_entry_points_default_to_cuda():
    """``run_sfm`` and ``run_sfm_from_matches`` default to the card and,
    without one, raise instead of running on the CPU."""
    import inspect

    from sift_tpu_torch.models import sfm

    for fn in (sfm.run_sfm, sfm.run_sfm_from_matches):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    frames = [np.zeros((48, 64, 3), np.float32)] * 3
    k = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sfm.run_sfm(frames, k)
    uv = np.zeros((20, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sfm.run_sfm_from_matches([uv, uv], {(0, 1): np.stack([np.arange(20)] * 2, 1)}, k)


PARALLEL_SLICE = ["parallel.mesh", "parallel.multihost", "parallel.dist", "parallel.spatial",
                  "parallel.ba_dist", "utils.checkpoint", "utils.profiling", "utils.debug"]


def test_parallel_slice_modules_stand_alone():
    """The multi-device layer and the checkpoint, profiling and debug utils
    import neither JAX nor the JAX package, directly or through what they
    import."""
    mods = "; ".join(f"import sift_tpu_torch.{m}" for m in PARALLEL_SLICE)
    code = (f"import sys; {mods}; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'sift_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_parallel_slice_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """``make_mesh``, ``detect_fn``, ``cached_detect``, ``shard_ba_problem``
    and ``load_keypoints`` default to the card and raise without one;
    ``batched_detect`` and ``spatial_detect_and_describe`` run on their
    mesh's device, which is the card unless ``make_mesh`` is asked for the
    CPU; ``initialize()`` without settings is a no-op."""
    import inspect

    import torch.distributed as dist

    from sift_tpu_torch.models.sift import detect_fn
    from sift_tpu_torch.parallel import batched_detect, make_mesh, spatial_detect_and_describe
    from sift_tpu_torch.parallel.ba_dist import shard_ba_problem
    from sift_tpu_torch.parallel.multihost import initialize
    from sift_tpu_torch.utils.checkpoint import cached_detect, load_keypoints

    for fn in (make_mesh, detect_fn, cached_detect, shard_ba_problem, load_keypoints):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    for fn in (batched_detect, spatial_detect_and_describe):
        assert inspect.signature(fn).parameters["mesh"].default is inspect.Parameter.empty
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    initialize()
    assert not dist.is_initialized()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_fn(np.zeros((32, 48), np.float32), SiftConfig(), 2)
    img = tmp_path / "a.png"
    img.write_bytes(b"")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cached_detect(str(img), cache_dir=str(tmp_path / "cache"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_ba_problem(np.zeros((2, 6)), np.zeros((1, 3)), np.zeros(2, int),
                         np.zeros(2, int), np.zeros((2, 2)), 1, np.ones(2), np.zeros(2),
                         np.zeros(2, bool))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_keypoints(str(tmp_path / "missing.npz"))


def test_pairwise_sq_dists_defaults_to_cuda_and_raises_without_it():
    import inspect

    from sift_tpu_torch import pairwise_sq_dists

    assert inspect.signature(pairwise_sq_dists).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    d = np.zeros((4, 128), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pairwise_sq_dists(d, d)


def test_streaming_path_defaults_to_cuda_and_raises_without_it(capsys):
    """The bench's functions take the card unless asked for the CPU; without
    one they raise, and ``bench.main`` exits 2 naming ``--device cpu``
    before it runs anything."""
    import inspect

    from sift_tpu_torch import bench

    fns = (bench.resident, bench.streaming, bench.scene_matches, bench.stream_sweeps,
           bench.stage_batches, bench.honesty_scan, bench.h2d_ceiling)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    assert bench.main([]) == 2
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(bench.stage_batches([np.zeros((8, 8, 3), np.uint8)], 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.resident(2, 1, 1)
