"""One incremental reconstruction a request: a whole rendered sequence
(``reference/sfm_plain``: the configuration's planes, textured with its
frames, seen by its camera along the request's trajectory; float32 host
arrays of whole grey levels) through ``models/sfm.run_sfm(frames, K, cfg,
ba_iters, match_window, loop_closure)`` with the configuration's ``sfm``
settings.  The request ends when the poses and points are host arrays.
Set-up renders every trajectory of the run (the order's seeds) on the
card.  The capacity check reads ``info["counts"]``, every frame's
detection counts, which ``run_sfm`` returns; a program that returns none
fails the request, and so does one whose last ``ba_solve`` computed no step
or returned the state it was handed.

The judge compares a sampled request with the plain references, each
number moving smoothly with its inputs:

* each frame's keypoints and descriptor bytes against
  ``reference/sift_plain`` on the same rendered frame, and each window
  pair's matches (the first calls of the matcher, in ``run_sfm``'s order)
  against ``reference/match_plain``, as the other cells do: the
  program's keypoints and matches are kept by wrapping the names
  ``models/sfm`` calls;
* ``Tally``'s numbers of the reconstruction: the trajectory error over
  the registered frames, the frames left unregistered, and the first step
  that the request's last ``ba_solve`` computed (kept, with the state,
  damping and Huber delta it was handed, by wrapping ``models/ba.ba_step``
  while the timed solve runs) against ``sfm_plain.dense_step`` from the
  same state with the configuration's camera.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools

import numpy as np
import torch

from benchmark import clients, judge
from benchmark.reference import match_plain, sfm_plain


class Tally(judge.Tally):
    """``judge.Tally`` and the reconstruction's numbers, the largest over
    the requests compared:

    * ``ate_pct_of_path``: the registered frames' camera centres after the
      best similarity to the ground truth, their RMS distance to it per
      100 of its path (``sfm_plain.ate_pct_of_path``);
    * ``frames_unregistered_pct``: frames without a pose, per 100 frames;
    * ``ba_step_off_pct``: the program's first step of the request's last
      bundle adjustment against the dense float64 step from the same
      state, relative L2 per 100 (``sfm_plain.step_off_pct``)."""

    def __init__(self):
        super().__init__()
        self.sequences = 0
        self.ate = self.unregistered = self.step_off = 0.0
        self.steps = 0
        self.which: list = []

    def trajectory(self, poses: np.ndarray, registered: list, gt: np.ndarray, which=None):
        self.sequences += 1
        self.which.append(which)
        n = len(gt)
        self.unregistered = max(self.unregistered, 100.0 * (n - len(registered)) / n)
        reg = sorted(registered)
        ate = (sfm_plain.ate_pct_of_path(sfm_plain.centres_of(poses[reg]), gt[reg])
               if len(reg) >= 3 else float("inf"))
        self.ate = max(self.ate, ate)

    def ba_step(self, prog: tuple, ref: tuple):
        self.steps += 1
        self.step_off = max(self.step_off, sfm_plain.step_off_pct(prog, ref))

    def compared(self) -> str:
        return super().compared() + (
            f", {self.sequences} trajectories, {self.steps} bundle-adjustment steps"
            f" (trajectories {self.which})" if self.sequences else "")

    def numbers(self) -> dict:
        out = super().numbers()
        if self.sequences:
            out.update(ate_pct_of_path=self.ate, frames_unregistered_pct=self.unregistered)
        if self.steps:
            out["ba_step_off_pct"] = self.step_off
        return out


@contextlib.contextmanager
def kept_calls(spans=None):
    """What the program's ``models/sfm`` calls inside the block, by
    wrapping the names it calls: ``keypoints`` (each detection's buffer,
    on the card), ``matches`` ((index, accepted, best distance) of each
    matcher call, on the card) and ``ba``, the last ``ba_solve``: the
    problem it was handed, the first step it computed (``models/ba.ba_step``
    while the solve runs: the problem, damping and Huber delta it was
    handed and the (cams, points) it returned; None if the solve computed
    none) and the (cams, points) the solve returned.  ``spans``: the
    client's spans, which then time each detection as ``entry`` (one a
    frame)."""
    from sift_tpu_torch.models import ba as ba_module
    from sift_tpu_torch.models import sfm

    kept = dict(keypoints=[], matches=[], ba=None)
    wrapped = {}

    def wrap(name, keep, span=None):
        call = getattr(sfm, name, None)
        if call is None:
            return

        def run(*a, **k):
            with (spans(span, len(a[0])) if spans and span else contextlib.nullcontext()):
                answer = call(*a, **k)
            keep(answer, a, k)
            return answer
        wrapped[name] = call
        setattr(sfm, name, run)

    def keypoints(answer, a, k):
        kept["keypoints"].append(answer[0] if isinstance(answer, tuple) else answer)

    solve = getattr(sfm, "ba_solve", None)

    def ba_solve(pr, *a, **k):
        first = []
        step = ba_module.ba_step

        def first_step(*sa, **sk):
            out = step(*sa, **sk)
            if not first:
                handed = inspect.signature(step).bind(*sa, **sk)
                handed.apply_defaults()
                first.append(dict(handed=handed.arguments, answer=out))
            return out
        ba_module.ba_step = first_step
        try:
            answer = solve(pr, *a, **k)
        finally:
            ba_module.ba_step = step
        kept["ba"] = dict(problem=pr, first=first[0] if first else None, answer=answer[:2])
        return answer

    wrap("detect_and_describe_batch", keypoints, "entry")
    wrap("match_descriptors", lambda answer, a, k: kept["matches"].append(answer[:3]))
    if solve is not None:
        wrapped["ba_solve"] = solve
        sfm.ba_solve = ba_solve
    try:
        yield kept
    finally:
        for name, call in wrapped.items():
            setattr(sfm, name, call)


def ba_faults(ba: dict | None) -> list[str]:
    """Why a request's last bundle adjustment is not one: no solve, a
    solve that computed no step, or one that returned the state it was
    handed (one host read of each)."""
    if ba is None:
        return ["run_sfm ran no bundle adjustment"]
    if ba["first"] is None:
        return ["the last ba_solve computed no step"]
    pr, (cams, pts) = ba["problem"], ba["answer"]
    if torch.equal(cams, pr.cams) and torch.equal(pts, pr.points):
        return ["the last ba_solve returned the state it was handed"]
    return []


def first_step(ba: dict) -> tuple:
    """The state, damping and Huber delta the last solve's first step was
    handed: (problem, lam, huber)."""
    handed = ba["first"]["handed"]
    return handed["pr"], float(handed["lam"]), handed["huber_delta"]


def host_problem(pr, k: np.ndarray | None = None) -> dict:
    """A ``BAProblem``'s numbers as numpy arrays; with ``k``, the camera's
    focal lengths and principal point from that matrix in place of the
    problem's."""
    out = {f: getattr(pr, f).detach().cpu().numpy()
           for f in ("cams", "points", "obs_cam", "obs_pt", "obs_uv", "obs_mask", "fxy", "cxy",
                     "fixed_cams")}
    if k is not None:
        out["fxy"] = np.array([k[0, 0], k[1, 1]], np.float64)
        out["cxy"] = np.array([k[0, 2], k[1, 2]], np.float64)
    return out


def program_step(ba: dict) -> tuple:
    """The program's first step of the kept ``ba_solve``, as it computed it
    inside the timed solve: (delta cams, delta points) as float64 numpy."""
    pr = first_step(ba)[0]
    cams, pts = ba["first"]["answer"]
    return ((cams - pr.cams).double().cpu().numpy(), (pts - pr.points).double().cpu().numpy())


def reference_step(ba: dict, k: np.ndarray, dev, **precision) -> tuple:
    """``sfm_plain.dense_step`` from the state the kept first step was
    handed, with the configuration's camera ``k``."""
    pr, lam, huber = first_step(ba)
    return sfm_plain.dense_step(host_problem(pr, k), lam, huber, dev, **precision)


class Client(clients.Client):
    def __init__(self, cell, frames, dev, spans, seconds: float, program=None):
        """``program``: the controls' stand-in for the program's first step
        of the judged bundle adjustment, ``step(problem, lam, huber, dev)``
        -> (delta cams, delta points), ``problem`` as ``host_problem``
        gives it with the configuration's camera."""
        super().__init__(cell, frames, dev, spans, seconds)
        self.step = program
        self.k = sfm_plain.intrinsics(cell.config["camera"])
        self.planes = tuple(tuple(p) for p in cell.config["scene"]["planes"])
        self.settings = dict(cell.config["sfm"])
        self.shape = (cell.config["camera"]["height"], cell.config["camera"]["width"])
        self.sequences: dict = {}

    def sequence(self, seed: int, tex) -> dict:
        m = self.mix
        centres, rots = sfm_plain.trajectory(seed, m["outward"], m["length_m"], m["jitter_m"],
                                             m["jitter_deg"], m["smooth_frames"])
        frames = [sfm_plain.render(self.k, c, r, tex, self.dev, self.shape, self.planes)
                  for c, r in zip(centres, rots)]
        return dict(frames=frames, centres=centres)

    def setup(self, reqs):
        """Every trajectory of the run rendered, from the first request's
        seeds."""
        first = next(reqs)
        tex = [torch.as_tensor(t, device=self.dev)
               for t in sfm_plain.textures(self.frames, self.planes)]
        for n, seed in enumerate(first["seeds"]):
            self.sequences[n] = self.sequence(seed, tex)
        return itertools.chain([first], reqs)

    def request(self, req) -> dict:
        frames = self.sequences[req["trajectory"]]["frames"]
        from sift_tpu_torch.models.sfm import run_sfm

        with kept_calls(self.spans) as kept:
            with self.spans("sfm", len(frames)):
                res = run_sfm(frames, self.k, self.cfg, device=self.dev, **self.settings)
        with self.spans("check"):
            counts = res.info.get("counts")
            bad = (["run_sfm returned no detection counts"] if counts is None
                   else clients.clipped(counts, self.cfg)) + ba_faults(kept["ba"])
        return dict(frames=len(frames), pairs=len(kept["matches"]), bad=bad,
                    poses=res.poses, registered=list(res.info.get("registered", [])),
                    kps=[kp.map(lambda a: a[0]) for kp in kept["keypoints"]],
                    matches=kept["matches"],
                    ba=kept["ba"])

    def plain(self, frame: np.ndarray) -> dict:
        """The plain reference's keypoints of one rendered frame."""
        from benchmark.reference import sift_plain

        kp = sift_plain.describe(torch.from_numpy(frame).to(self.dev), self.cell.config["sift"])
        out = {k: kp[k].cpu().numpy() for k in judge.FIELDS + ("desc",)}
        out["desc_t"] = kp["desc"]
        return out

    def judge(self, samples, reference) -> judge.Tally:
        tally = Tally()
        ratio = self.cfg.ratio_threshold
        window = self.settings.get("match_window", 2)
        for s in samples:
            seq = self.sequences[s["req"]["trajectory"]]
            tally.trajectory(np.asarray(s["poses"], np.float64), s["registered"], seq["centres"],
                             s["req"]["trajectory"])
            if s["ba"] is not None and s["ba"]["first"] is not None:
                ref = reference_step(s["ba"], self.k, self.dev)
                if self.step is None:
                    prog = program_step(s["ba"])
                else:
                    pr, lam, huber = first_step(s["ba"])
                    prog = self.step(host_problem(pr, self.k), lam, huber, self.dev)
                tally.ba_step(prog, ref)
                s["ba"] = None
                if self.dev.type == "cuda":
                    torch.cuda.empty_cache()
            kps = s["kps"]
            if len(kps) != len(seq["frames"]):
                raise RuntimeError(f"the request detected {len(kps)} of "
                                   f"{len(seq['frames'])} frames")
            refs = [self.plain(f) for f in seq["frames"]]
            valid = [kp.valid.cpu().numpy() for kp in kps]
            pairing = [tally.frame({k: getattr(kp, k).cpu().numpy()[v]
                                    for k in judge.FIELDS + ("desc",)}, ref)
                       for kp, v, ref in zip(kps, valid, refs)]
            n = len(kps)
            pairs = [(i, j) for i in range(n - 1) for j in range(i + 1, min(i + 1 + window, n))]
            for (i, j), m in zip(pairs, s["matches"]):
                prog = clients.valid_order(*[a.cpu().numpy() for a in m], valid[i], valid[j])
                plain = tuple(a.cpu().numpy() for a in match_plain.ratio_matches(
                    refs[i]["desc_t"], refs[j]["desc_t"], ratio))
                tally.matches(prog, pairing[i], pairing[j], plain)
        return tally

    def work(self, records) -> dict:
        return dict(frames=sum(r["frames"] for r in records), requests=len(records),
                    frame_shape=self.shape + (3,))
