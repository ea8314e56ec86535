"""The SfM cell's pieces on the CPU: the plain reference's bundle-adjustment
step, trajectory error and scene against the program and the evaluation
script, and the cell end to end at a small size (a 12-frame sequence at a
quarter of the width, in a copy of the benchmark, ``tiny``): a sound
program is correct and each planted fault fails a limit."""

from __future__ import annotations

import importlib.util
import json

import numpy as np
import pytest
import torch

import sift_tpu_torch.models.ba as PB
import sift_tpu_torch.models.sfm as PF
from benchmark import harness
from benchmark.reference import sfm_plain
from benchmark.tests import tiny

torch.set_num_threads(2)
SEED = 2**33 + 5
CELL = "tiny_sfm_vga.tiny_loop"
HERE = harness.ROOT / "benchmark"
CAMERA = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3)


def ba_problem(seed: int, n_cams: int = 6, n_pts: int = 200):
    """A random problem: cameras along x looking at points 4-9 m away, every
    point seen by 2-6 cameras, 0.5 px of noise, 5% of observations 20 px
    off, cameras 0 and 1 fixed; the state perturbed from the truth."""
    rng = np.random.default_rng(seed)
    k = sfm_plain.intrinsics(CAMERA)
    pts = rng.uniform([-2, -1.5, 4], [3, 1.5, 9], (n_pts, 3))
    centres = np.stack([np.linspace(0, 1, n_cams), rng.normal(0, .02, n_cams),
                        rng.normal(0, .02, n_cams)], 1)
    rots = sfm_plain.rotation(rng.normal(0, 0.02, (n_cams, 3)))
    poses = sfm_plain.poses_of(centres, rots)
    oc, op, uv = [], [], []
    for p in range(n_pts):
        for c in sorted(rng.choice(n_cams, int(rng.integers(2, n_cams + 1)), replace=False)):
            oc.append(c)
            op.append(p)
            uv.append(sfm_plain.project(k, centres[c], rots[c], pts[p:p + 1])[0])
    uv = np.asarray(uv) + rng.normal(0, 0.5, (len(uv), 2))
    bad = rng.uniform(size=len(uv)) < 0.05
    uv[bad] += 20.0
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    cams = poses + np.where(fixed[:, None], 0.0, rng.normal(0, 0.01, poses.shape))
    return dict(cams=cams, points=pts + rng.normal(0, 0.05, pts.shape),
                obs_cam=np.asarray(oc), obs_pt=np.asarray(op), obs_uv=uv,
                obs_mask=rng.uniform(size=len(uv)) > 0.02,
                fxy=np.array([k[0, 0], k[1, 1]]), cxy=np.array([k[0, 2], k[1, 2]]),
                fixed_cams=fixed)


def program_step(problem: dict, dtype, lam: float, huber):
    arrays = {n: (v.astype(dtype) if np.asarray(v).dtype.kind == "f" else v)
              for n, v in problem.items()}
    arrays["obs_by_point"] = PB.build_obs_by_point(problem["obs_pt"], len(problem["points"]))
    pr = PB.ba_problem_from_numpy(arrays, "cpu")
    cams, pts = PB.ba_step(pr, torch.tensor(lam, dtype=pr.cams.dtype), huber)
    return ((cams - pr.cams).double().numpy(), (pts - pr.points).double().numpy())


# float32 against float64: the reduced camera system's rounding
F32_STEP_OFF_PCT = 0.5


@pytest.mark.parametrize("huber", [None, 3.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_dense_step_is_the_programs_schur_step(seed, huber):
    """The program's Schur-complement step in float64 is the dense normal
    equations' step to 1e-9 relative; in float32 within
    ``F32_STEP_OFF_PCT`` per 100 (relative L2); the fixed cameras do not
    move."""
    problem = ba_problem(seed)
    ref = sfm_plain.dense_step(problem, 1e-3, huber)
    assert np.abs(ref[0][:2]).max() == 0.0
    got = program_step(problem, np.float64, 1e-3, huber)
    assert sfm_plain.step_off_pct(got, ref) < 1e-7
    got32 = program_step(problem, np.float32, 1e-3, huber)
    assert sfm_plain.step_off_pct(got32, ref) < F32_STEP_OFF_PCT
    # the controls' variants: float32 is sound, so it reads low
    assert sfm_plain.step_off_pct(sfm_plain.dense_step(problem, 1e-3, huber,
                                                       dtype=torch.float32), ref) < 1.0


def _eval_script():
    spec = importlib.util.spec_from_file_location(
        "torch_sfm_eval", harness.ROOT / "scripts" / "torch_sfm_eval.py")
    ev = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ev)
    return ev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ate_is_the_evaluation_scripts(seed):
    """``sfm_plain.ate_pct_of_path`` equals ``scripts/torch_sfm_eval._metrics``
    to 1e-12 on a similarity-moved, noisy trajectory; the centres of
    ``poses_of`` are the trajectory's."""
    ev = _eval_script()
    centres, rots = sfm_plain.trajectory(seed)
    np.testing.assert_allclose(sfm_plain.centres_of(sfm_plain.poses_of(centres, rots)), centres,
                               atol=1e-12)
    rng = np.random.default_rng(seed)
    moved = 3.0 * centres @ sfm_plain.rotation(rng.normal(0, 1, 3)).T + rng.normal(0, 1, 3)
    moved += rng.normal(0, 0.01, moved.shape)
    want = ev._metrics(moved, centres)["ate_pct_of_path"]
    assert sfm_plain.ate_pct_of_path(moved, centres) == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert want > 0.01


def test_the_trajectory_goes_out_and_back():
    centres, rots = sfm_plain.trajectory(SEED)
    assert len(centres) == 48
    np.testing.assert_allclose(centres[24, 0], 1.6)
    np.testing.assert_allclose(centres[25:, 0], centres[23:0:-1, 0])
    assert 0.002 < np.std(centres[:, 1:]) < 0.02
    assert np.allclose(np.einsum("nij,nkj->nik", rots, rots), np.eye(3), atol=1e-12)


def textures():
    frames = harness.load_frames(json.loads((HERE / "configs" / "sfm_vga.json").read_text()))
    return [torch.as_tensor(t) for t in sfm_plain.textures(frames)]


def test_the_renderer_holds_its_ground_truth():
    """A pixel's texel, as a world point, projects back to the pixel within
    0.01 px, on every plane; the same seed renders the same bits; every
    pixel sees a plane."""
    k = sfm_plain.intrinsics(CAMERA)
    centres, rots = sfm_plain.trajectory(SEED)
    v, u = np.mgrid[0:480:13, 0:640:17].astype(np.float64)
    u, v = u.ravel(), v.ravel()
    for f in (0, 24, 47):
        plane, col, row = sfm_plain.cast(k, centres[f], rots[f], u, v)
        plane = plane.numpy()
        assert set(plane.tolist()) == {0, 1, 2}
        for p in range(3):
            m = plane == p
            x = sfm_plain.texel_point(p, col.numpy()[m], row.numpy()[m])
            uv = sfm_plain.project(k, centres[f], rots[f], x)
            assert np.abs(uv - np.stack([u[m], v[m]], 1)).max() < 0.01
    tex = textures()
    small = (96, 128)
    ks = k.copy()
    ks[:2] /= 5.0
    a = sfm_plain.render(ks, centres[3], rots[3], tex, shape=small)
    b = sfm_plain.render(ks, centres[3], rots[3], tex, shape=small)
    assert a.dtype == np.float32 and a.shape == small + (3,)
    assert np.array_equal(a, b) and np.array_equal(a, np.round(a))
    assert (a.sum(-1) > 0).mean() > 0.99


# ---- the cell at a small size ------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny checkout with the cell ``tiny_sfm_vga.tiny_loop``: 12
    frames (7 out) at 320 x 240, capacities 2048 / 512 / 1024."""
    root = tiny.make(tmp_path_factory.mktemp("checkout"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "sfm_vga.json").read_text())
    cfg["sift"].update(extrema_cap=2048, kp_cap=512, ori_cap=1024)
    cam = cfg["camera"]
    for key in ("fx", "fy", "cx", "cy"):
        cam[key] /= 2
    cam["width"], cam["height"] = 320, 240
    (root / "benchmark" / "configs" / "tiny_sfm_vga.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "loop48.json").read_text())
    mix["outward"] = 7
    (root / "benchmark" / "traffic" / "tiny_loop.json").write_text(json.dumps(mix))
    spec["configs"].append(dict(name="tiny_sfm_vga", source="test", reduced=[], why="test",
                                file="benchmark/configs/tiny_sfm_vga.json"))
    spec["workloads"].append(dict(name=CELL, config="tiny_sfm_vga", traffic="tiny_loop",
                                  chips=1, why="test"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sfm_vga.loop48" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "limits" / f"{CELL}.json").write_text(
        (HERE / "limits" / "sfm_vga.loop48.json").read_text())
    return root


def run(root):
    return harness.run_cell(CELL, SEED, 0.5, False, "cpu", hooks=dict(root=root))


@pytest.fixture(scope="module")
def sound(root):
    """The sound program's run of the tiny cell."""
    return run(root)


def test_the_cell_runs_and_a_sound_program_is_correct(sound):
    result, lines = sound
    assert result["correct"], lines
    assert {"ate_pct_of_path", "frames_unregistered_pct", "ba_step_off_pct"} <= set(
        result["checks"])
    assert result["attempted"] >= 1 and "frames_per_s" in result["metrics"]
    assert "21 pairs, 1 trajectories, 1 bundle-adjustment steps" in lines[0]


def test_the_order_takes_the_trajectories_in_turn():
    order = harness.load_module(HERE, "orders", "trajectories")
    mix = json.loads((HERE / "traffic" / "loop48.json").read_text())
    reqs = order.requests(mix, 6, SEED)
    first = [next(reqs) for _ in range(8)]
    assert [r["index"] for r in first] == list(range(-1, 7))
    assert all(r["frames"] == list(range(48)) and r["seeds"] == first[0]["seeds"] for r in first)
    assert len(set(first[0]["seeds"])) == 4
    assert sorted(r["trajectory"] for r in first[:4]) == [0, 1, 2, 3]
    assert sorted(r["trajectory"] for r in first[4:]) == [0, 1, 2, 3]


def focal_off(monkeypatch):
    """The program handed fx scaled by 1.05."""
    solve = PF.run_sfm_from_matches

    def wrong(uvs, pm, intrinsics, *a, **k):
        k2 = np.array(intrinsics, np.float64)
        k2[0, 0] *= 1.05
        return solve(uvs, pm, k2, *a, **k)
    monkeypatch.setattr(PF, "run_sfm_from_matches", wrong)


def ba_skipped(monkeypatch):
    monkeypatch.setattr(PF, "ba_solve", lambda pr, *a, **k: (pr.cams, pr.points,
                                                             {"cost_trace": [0.0]}))


def pose_zeroed(monkeypatch):
    """One registered frame's pose returned as zeros."""
    run_sfm = PF.run_sfm

    def wrong(*a, **k):
        res = run_sfm(*a, **k)
        res.poses[res.info["registered"][len(res.info["registered"]) // 2]] = 0.0
        return res
    monkeypatch.setattr(PF, "run_sfm", wrong)


@pytest.mark.parametrize("fault, check", [(pose_zeroed, "ate_pct_of_path"),
                                          (ba_skipped, None), (focal_off, "ba_step_off_pct")],
                         ids=lambda f: getattr(f, "__name__", f))
def test_each_planted_fault_fails_the_cell(root, sound, monkeypatch, fault, check):
    """One zeroed pose fails the trajectory limit; a skipped bundle
    adjustment computes no step, so its first request, the warm-up, fails
    the run; fx scaled by 1.05 leaves the program's step far from the
    dense step of the configuration's camera."""
    fault(monkeypatch)
    if check is None:
        with pytest.raises(RuntimeError, match="the last ba_solve computed no step"):
            run(root)
        return
    result, lines = run(root)
    assert not result["correct"] and result["failed"] == 0, lines
    assert result["checks"][check]["value"] > result["checks"][check]["limit"], lines


def test_the_judged_step_is_the_one_the_timed_solve_computed(root, sound, monkeypatch):
    """The judge reads the first step of the request's last solve as the
    solve computed it: a solve whose steps are scaled by 1.01 fails the
    step limit (a step recomputed after the window would not see it), and
    the step ``ba_solve`` returns unchanged fails the request."""
    step = PB.ba_step

    def scaled(pr, lam, huber_delta=None):
        cams, pts = step(pr, lam, huber_delta)
        return pr.cams + 1.01 * (cams - pr.cams), pr.points + 1.01 * (pts - pr.points)
    monkeypatch.setattr(PB, "ba_step", scaled)
    result, lines = run(root)
    assert not result["correct"] and result["failed"] == 0, lines
    assert result["checks"]["ba_step_off_pct"]["value"] > 0.9, lines


def test_a_stand_in_step_goes_through_the_judge(root):
    """The controls' stand-in for the judged step: the dense step in
    float32 (a sound reordering) comes out correct, the same step 1% long
    does not."""
    def dense32(problem, lam, huber, dev):
        return sfm_plain.dense_step(problem, lam, huber, dev, torch.float32)

    def long(problem, lam, huber, dev):
        dc, dp = sfm_plain.dense_step(problem, lam, huber, dev)
        return 1.01 * dc, 1.01 * dp
    for step, good in ((dense32, True), (long, False)):
        result, lines = harness.run_cell(CELL, SEED, 0.5, False, "cpu",
                                         hooks=dict(root=root, program=step))
        assert result["correct"] is good, lines
