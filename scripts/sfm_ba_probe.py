"""One RANSAC stream's global bundle adjustment, the JAX package's against the port's.

Runs the port's ``run_sfm_from_matches`` on one of
``scripts/torch_sfm_eval.py``'s sequences (``--sequence``: sweep-50,
loop-49 or bigloop-97) at one seed (the matches and draws as
``scripts/sfm_stream_spread.py`` makes them) and
keeps the state it hands to ``_finish_global_ba``: poses, points, tracks.
From that one state it then runs the final stage of both packages (the
JAX package's with x64 off, on the CPU) and prints their cost traces and
outcomes (ATE % of the path, frames registered, observations pruned),
the worst reprojection errors of the state, and, for the first
LM damping values, the cost after one ``ba_step`` in float32 in each
package and in float64 in the port, with each float32 camera step's
largest distance from the float64 one; and SHA-256 digests of one Huber
LM step's pieces from that state (the Schur sums U, g_c, sum Y W^T, sum
Y g, V^-1, and the camera solve of the port and of the JAX package), so
that two runs at other ``--threads`` counts show which of them follow the
thread count.

    python3 scripts/sfm_ba_probe.py --seed 1000 [--sequence sweep-50] [--detector jax]
        [--draws jax] [--threads N]

Needs JAX; CPU only.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import sfm_stream_spread as SP  # noqa: E402
import sift_tpu.models.ba as JB  # noqa: E402
import sift_tpu.models.sfm as JF  # noqa: E402
import sift_tpu_torch.models.ba as PB  # noqa: E402
import sift_tpu_torch.models.geometry as PG  # noqa: E402
import sift_tpu_torch.models.sfm as PF  # noqa: E402

HUBER = 3.0  # run_sfm_from_matches' prune_px, the final BA's Huber delta


def outcome(res, ev, gt):
    info = res.info
    return dict(ate_pct=ev.trajectory_metrics(ev.camera_centers(res.poses), gt)["ate_pct_of_path"],
                registered=len(info["registered"]), pruned_obs=info.get("pruned_obs", 0),
                cost_trace=info["ba"]["cost_trace"],
                reprune_cost_trace=info.get("ba_reprune", {}).get("cost_trace"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sequence", default="sweep-50", choices=("sweep-50", "loop-49", "bigloop-97"))
    ap.add_argument("--threads", type=int, default=None,
                    help="host threads (see scripts/sfm_stream_spread.py)")
    ap.add_argument("--detector", default="port", choices=("port", "jax"))
    ap.add_argument("--draws", default="own", choices=("own", "jax"))
    args = ap.parse_args()
    if args.threads:
        SP.set_threads(args.threads)
    ev = C.port_script("torch_sfm_eval")
    frames, gt = ev.render_sequence(ev.texture(), ts=ev.sequences(C.SFM_FRAMES)[args.sequence])
    uvs, pm = SP.detect_and_match(frames, torch.device("cpu"), args.detector)
    if args.draws == "jax":
        PG.sample_choice = SP.jax_draws
    k = np.array(C.SFM_K)
    state = []
    finish = PF._finish_global_ba

    def keep(*a, **kw):
        state.append(copy.deepcopy(a[:6]) + a[6:])
        return finish(*a, **kw)

    PF._finish_global_ba = keep
    PF.run_sfm_from_matches(uvs, dict(pm), k, C.SFM_BA_ITERS, seed=args.seed, device="cpu")
    PF._finish_global_ba = finish
    a = state[0]
    port = finish(*copy.deepcopy(a[:6]) + a[6:], device="cpu")
    with jax.enable_x64(False):
        ref = JF._finish_global_ba(*copy.deepcopy(a[:6]) + a[6:])

    n_frames, poses, points, track_obs, track_point, registered, fa, fb, fxy, cxy, uv_of = a[:11]
    pts = np.asarray(points)
    obs_cam, obs_pt, obs_uv = PF._observations(track_obs, track_point, registered)
    fixed = np.zeros(n_frames, bool)
    fixed[[fa, fb]] = True
    arrays = dict(cams=poses, points=pts, obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=obs_uv,
                  obs_mask=np.ones(len(obs_cam), bool),
                  obs_by_point=PB.build_obs_by_point(obs_pt, len(pts)), fxy=np.asarray(fxy),
                  cxy=np.asarray(cxy), fixed_cams=fixed)

    def port_problem(dt):
        return PB.ba_problem_from_numpy(
            {n: v.astype(dt) if np.asarray(v).dtype.kind == "f" else v for n, v in arrays.items()},
            "cpu")

    p32, p64 = port_problem(np.float32), port_problem(np.float64)
    # One Huber LM step's pieces from this state in float32: their digests
    # tell which of them change between runs at two --threads counts.
    r, jc, jp = PB._jacobians(p32, p32.cams, p32.points)
    sw = PB._huber_sqrt_weights(r, HUBER)
    r, jc, jp = r * sw[:, None], jc * sw[:, None, None], jp * sw[:, None, None]
    lam32 = torch.tensor(1e-3, dtype=torch.float32)
    u, g_c, yw, yg, v_inv, *_ = PB._schur_parts(p32, jc, jp, r, lam32)
    s, rhs = PB._schur_combine(u, g_c, yw, yg, lam32)
    with jax.enable_x64(False):
        solve_jax = JB._solve_cameras(jnp.asarray(s.permute(0, 2, 1, 3).numpy()),
                                      jnp.asarray(rhs.numpy()), fixed)
    pieces = dict(U=u, g_c=g_c, YW=yw, Yg=yg, V_inv=v_inv,
                  solve_port=PB._solve_cameras(s, rhs, p32.fixed_cams), solve_jax=solve_jax)
    digests = {name: hashlib.sha256(np.ascontiguousarray(np.asarray(t)).tobytes()).hexdigest()[:16]
               for name, t in pieces.items()}
    r, z = PB._residuals(p64, p64.cams, p64.points)
    err = r.norm(dim=1)
    worst = torch.argsort(err, descending=True)[:5]
    steps = []
    with jax.enable_x64(False):
        jpr = JB.BAProblem(**{n: jnp.asarray(v, jnp.float32) if np.asarray(v).dtype.kind == "f"
                              else jnp.asarray(v) for n, v in arrays.items()})
        lam = 1e-3
        for _ in range(6):
            cj, xj = (torch.from_numpy(np.asarray(v, np.float64))
                      for v in JB.ba_step(jpr, jnp.asarray(lam, jnp.float32), HUBER))
            c32, x32 = PB.ba_step(p32, torch.tensor(lam, dtype=torch.float32), HUBER)
            c64, x64 = PB.ba_step(p64, torch.tensor(lam, dtype=torch.float64), HUBER)

            def cost(c, x):
                return float(PB._cost(p64, c.double(), x.double(), HUBER))

            steps.append(dict(lam=lam, cost_jax_f32=cost(cj, xj), cost_port_f32=cost(c32, x32),
                              cost_port_f64=cost(c64, x64),
                              cam_err_jax_f32=float((cj - c64).abs().max()),
                              cam_err_port_f32=float((c32.double() - c64).abs().max())))
            lam *= 4.0
    print(json.dumps(dict(
        seed=args.seed, sequence=args.sequence, threads=torch.get_num_threads(),
        detector=args.detector, draws=args.draws, frames_registered=len(registered),
        points=len(pts), observations=len(obs_cam), initial_cost_f64=cost(p64.cams, p64.points),
        worst_reprojection_px=err[worst].tolist(), worst_depth=z[worst].tolist(),
        jax=outcome(ref, ev, gt), port=outcome(port, ev, gt), one_step=steps,
        step_digests=digests)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
