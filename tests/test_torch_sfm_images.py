"""End-to-end SfM from rendered images on the CPU: the port's ``run_sfm``
(detection, matching, verification, tracks, two-view init, PnP, BA) on the
JAX package's 6-frame rendered sequence (``tests/test_sfm_images.py``),
within that test's bound; and the pieces ``chip_smoke.py``'s ``sfm`` phase
uses to drive it on the card (``scripts/torch_sfm_eval.py``'s renderer
with the texture passed in, its sequences and trajectory metrics) against
the JAX package's.

The texture is CAVE-01 frame 00 as the oracle decoded it
(``tests/data/scene_oracle/cave01_00.npz``), the JAX test's photograph.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
import test_sfm_images
from sift_tpu_torch import SiftConfig
from sift_tpu_torch.models import sfm as PF
from sift_tpu_torch.models.geometry import rodrigues

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("torch_sfm_eval",
                                               ROOT / "scripts" / "torch_sfm_eval.py")
EV = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(EV)


def _render_cases():
    """(name, camera positions) of the renderer's cases: the JAX test's
    own 6 frames, every 7th of sweep-50, a stretch of the multi-pass loop,
    and ``scripts/sfm_eval.py``'s three sequences at 8 frames."""
    seqs = EV.sequences(50)
    return [("jax-test-6", None), ("sweep-50-every-7th", seqs["sweep-50"][::7]),
            ("bigloop-97-28-40", seqs["bigloop-97"][28:40]),
            *EV.sequences(8).items()]


@pytest.mark.parametrize("case", range(len(_render_cases())),
                         ids=[name for name, _ in _render_cases()])
def test_renderer_and_sequences_match_the_jax_evaluation(monkeypatch, case):
    """The renderer gives the JAX test's frames bit for bit when the JAX
    test's texture loader returns the same photograph; the sequences are
    ``scripts/sfm_eval.py``'s sweep-50 and the 97-frame multi-pass loop.
    Tolerance: none."""
    tex = EV.texture()
    assert tex.shape == (480, 640, 3) and tex.dtype == np.float32
    monkeypatch.setattr(test_sfm_images, "load_image", lambda path: tex)
    seqs = chip_smoke.sfm_sequences()
    assert {k: len(v) for k, v in seqs.items()} == {"sweep-50": 50, "bigloop-97": 97}
    loop = np.asarray(seqs["bigloop-97"])
    assert loop[0] == 0 and loop[32] == pytest.approx(1.6 * 32 / 33) and loop[64] == 0
    name, ts = _render_cases()[case]
    got, gc = EV.render_sequence(tex, ts=ts)
    want, wc = test_sfm_images.render_sequence(ts=ts)
    assert len(got) == len(want) == (6 if ts is None else len(ts)), name
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gc, wc)


def _trajectories():
    """Seeded (estimate, ground truth) pairs: a noisy similarity of a
    straight sweep, a noisy similarity of a 3-D path, and the same
    mirrored (a reflection, which the alignment must not take)."""
    rng = np.random.default_rng(0)
    sweep = np.stack([np.linspace(0, 1.6, 40), np.zeros(40), np.zeros(40)], 1)
    rot = rodrigues(torch.tensor([0.1, -0.3, 0.2], dtype=torch.float64)).numpy()
    sweep_est = 0.7 * sweep @ rot.T + [0.2, -0.1, 0.5] + rng.normal(0, 0.01, sweep.shape)
    path = np.cumsum(rng.normal(0, 0.1, (30, 3)), axis=0)
    est = 0.7 * path @ rot.T + [0.2, -0.1, 0.5] + rng.normal(0, 0.01, path.shape)
    return {"sweep": (sweep_est, sweep), "similarity": (est, path),
            "reflection": (est * [1.0, 1.0, -1.0], path)}


@pytest.mark.parametrize("case", ["sweep", "similarity", "reflection"])
def test_trajectory_metrics_match_sfm_eval(case):
    """ATE-RMSE, RPE, the path and ATE % of path as ``scripts/sfm_eval.py``'s
    ``_metrics`` computes them, on a noisy, rotated and scaled trajectory
    (and a mirrored one, whose best rotation is not a reflection).
    Tolerance: 1e-12 relative."""
    spec = importlib.util.spec_from_file_location("sfm_eval", ROOT / "scripts" / "sfm_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    est, gt = _trajectories()[case]
    want = mod._metrics(est, gt)
    assert EV._metrics(est, gt).keys() == want.keys()
    for got in (EV._metrics(est, gt), EV.trajectory_metrics(est, gt)):
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
    got = EV.trajectory_metrics(est, gt)
    assert got["rpe_pct_of_path"] == pytest.approx(100 * want["rpe_rmse_m"] / want["path_m"])
    if case == "reflection":
        assert got["ate_rmse_m"] > 0.01


def test_run_sfm_on_rendered_sequence():
    """``run_sfm(device="cpu")`` on the 6-frame sequence at the JAX test's
    configuration (float32, capacities 2048 / 1024 / 2048, 15 BA
    iterations): more than 30 points, every frame registered, and the
    camera track a straight +x translation within the JAX test's bound
    (ATE after scaling on the last centre under 0.15 x the span)."""
    frames, gt = EV.render_sequence(EV.texture())
    k = np.array(chip_smoke.SFM_K)
    res = PF.run_sfm(frames, k, SiftConfig(**chip_smoke.SFM_CAPS), ba_iters=15, device="cpu")
    assert res.info["n_points"] > 30, res.info
    assert res.info["registered"] == list(range(6))
    assert np.isfinite(res.poses).all() and np.isfinite(res.points).all()
    centers = EV.camera_centers(res.poses)
    norm_est = np.linalg.norm(centers[-1])
    assert norm_est > 1e-6
    scaled = centers * (np.linalg.norm(gt[-1]) / norm_est)
    ate = np.sqrt(((scaled - gt) ** 2).sum(axis=1).mean())
    span = np.linalg.norm(gt[-1] - gt[0])
    assert ate < 0.15 * span, (ate, span, scaled[:, 0])


def test_run_sfm_reports_each_frames_detection_counts():
    """``run_sfm(device="cpu")`` on the 6-frame sequence returns in
    ``info["counts"]`` every frame's detection counts in the entry point's
    layout: those of ``detect_and_describe_batch(..., return_counts=True)``
    on the six frames as one batch.  Tolerance: none."""
    from sift_tpu_torch.models.sift import clipped, detect_and_describe_batch

    frames, _ = EV.render_sequence(EV.texture())
    cfg = SiftConfig(**chip_smoke.SFM_CAPS)
    res = PF.run_sfm(frames, np.array(chip_smoke.SFM_K), cfg, ba_iters=1, loop_closure=False,
                     device="cpu")
    _, want = detect_and_describe_batch(np.stack(frames), cfg, return_counts=True, device="cpu")
    got = res.info["counts"]
    assert sorted(got) == sorted(want)
    for name in want:
        got_n = got[name].reshape(len(frames), -1) if want[name].dim() else got[name].max()
        want_n = want[name].reshape(len(frames), -1) if want[name].dim() else want[name]
        np.testing.assert_array_equal(got_n.numpy(), want_n.numpy(), err_msg=name)
    assert clipped(got, cfg) == clipped(want, cfg)
