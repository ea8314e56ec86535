"""What the clients share.  A client (``clients/<client>.py``, named by a
mix's ``client``) defines ``Client``: it sets up what its requests need,
hands each request to the program, says what its records carry for the
metric readers and judges a sample of its answers against the plain
reference.  ``Client.drive`` is its arrival loop; the one here is closed
loop with one client: a request is handed over when the one before has
its matches on the host.  A client with other arrivals overrides it.
"""

from __future__ import annotations

import numpy as np

from benchmark import judge
from benchmark.reference import match_plain


def entry_points():
    """The program under test: (detect_and_describe_batch, match_descriptors)."""
    from sift_tpu_torch.models.match import match_descriptors
    from sift_tpu_torch.models.sift import detect_and_describe_batch

    return detect_and_describe_batch, match_descriptors


def sift_config(config: dict):
    from sift_tpu_torch.config import SiftConfig

    return SiftConfig(**config["sift"])


def clipped(counts: dict, cfg) -> list[str]:
    """Every count of the entry point's ``return_counts`` above its capacity:
    extrema, refined, oriented, each Newton phase's lanes (the cascade's
    caps n // 4 and n // 8, at least 128, or ``refine_active_cap``) and the
    orientation slots."""
    host = {k: np.asarray(v.cpu()) for k, v in counts.items()}
    out = []
    for name, cap in (("extrema", cfg.extrema_cap), ("refined", cfg.kp_cap),
                      ("oriented", cfg.ori_cap)):
        out += [f"frame {f}: {name} {int(v)} > {cap}" for f, v in enumerate(host[name]) if v > cap]
    n = cfg.extrema_cap
    caps = ([cfg.refine_active_cap] if cfg.refine_active_cap
            else [max(128, n // 4), max(128, n // 8)])
    for p, cap in enumerate(caps):
        out += [f"frame {f}: refine_active[{p}] {int(v)} > {cap}"
                for f, v in enumerate(host["refine_active"][:, p]) if v > cap]
    if int(host["ori_slots_max"].max()) > cfg.ori_cand_slots:
        out.append(f"ori_slots_max {int(host['ori_slots_max'].max())} > {cfg.ori_cand_slots}")
    return out


def frame_dict(kp, f: int) -> dict:
    """Frame ``f`` of a program ``Keypoints`` buffer as the judge reads it:
    numpy arrays of its valid lanes in lane order."""
    v = kp.valid[f].cpu().numpy()
    return {k: getattr(kp, k)[f].cpu().numpy()[v] for k in judge.FIELDS + ("desc",)}


def valid_order(idx, acc, best, valid1, valid2):
    """Lane-indexed matcher outputs of one pair -> (best_idx, accept, best
    squared distance) over the valid query keypoints, best_idx naming a
    valid target keypoint (-1: none)."""
    v1, v2 = np.asarray(valid1), np.asarray(valid2)
    rank2 = np.cumsum(v2) - 1
    idx, acc, best = (np.asarray(a)[v1] for a in (idx, acc, best))
    return np.where(v2[idx], rank2[idx], -1), acc, best


def plain_matches(reference, key1, key2, ratio):
    return tuple(a.cpu().numpy() for a in match_plain.ratio_matches(
        reference(key1)["desc_t"], reference(key2)["desc_t"], ratio))


class Client:
    """``cell``: the ``harness.Cell``; ``frames``: its frames, (H, W, 3)
    uint8 each; ``spans``: the host-clock spans of a traced run;
    ``program``: a (detect, match) pair in the entry points' place (the
    control and the tests)."""

    def __init__(self, cell, frames, dev, spans, seconds: float, program=None):
        self.detect, self.match = program or entry_points()
        self.cell, self.mix, self.frames, self.dev = cell, cell.mix, frames, dev
        self.spans, self.seconds = spans, seconds
        self.cfg = sift_config(cell.config)

    def setup(self, reqs):
        """Set-up before the warm-up request; returns the requests."""
        return reqs

    def request(self, req) -> dict:
        """Hand ``req`` to the program and wait for its answers on the host:
        a dict with ``frames`` and ``pairs`` (the work done), ``bad`` (why
        it failed: a clipped count) and what ``judge`` reads."""
        raise NotImplementedError

    def drive(self, reqs, window):
        """The arrival loop: closed, one client."""
        while window.running():
            req = next(reqs, None)
            if req is None:
                return
            window.send(req, self.request)

    def close(self):
        """Free the program's state before the check."""

    def judge(self, samples, reference) -> judge.Tally:
        raise NotImplementedError

    def work(self, records) -> dict:
        """What the traced requests asked of the kernels, for the roofline
        readers."""
        return {}
