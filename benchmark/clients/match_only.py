"""Set-up extracts every frame's features through the entry point and keeps
them on the card, and uploads the frame pairs of every request it plans;
each request matches its pairs (``match``) in calls of the mix's
``pairs_per_call``, each call's results copied to the host."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import clients, judge

# Set-up plans enough requests for this many a second through the window.
PLAN_REQUESTS_PER_S = 300


class Client(clients.Client):
    def setup(self, reqs):
        kp, counts = self.detect(np.stack(self.frames), self.cfg, return_counts=True,
                                 device=self.dev)
        bad = clients.clipped(counts, self.cfg)
        if bad:
            raise RuntimeError("set-up extraction clipped: " + "; ".join(bad))
        self.kp = kp
        self.n_valid = kp.valid.sum(1).cpu().tolist()
        plan = [next(reqs) for _ in range(2 + int(self.seconds * PLAN_REQUESTS_PER_S))]
        for at, r in enumerate(plan):
            r["at"] = at
        self.ij = torch.from_numpy(np.stack([r["match"] for r in plan])).to(self.dev)
        return iter(plan)

    def request(self, req) -> dict:
        ij = self.ij[req["at"]]
        per_call = self.mix["pairs_per_call"]
        idx, acc, best = [], [], []
        for s in range(0, len(ij), per_call):
            a, b = ij[s:s + per_call, 0], ij[s:s + per_call, 1]
            with self.spans("match", len(a)):
                m = self.match(self.kp.desc[a], self.kp.valid[a], self.kp.desc[b],
                               self.kp.valid[b], self.cfg.ratio_threshold, device=self.dev)
                idx.append(m[0].cpu())
                acc.append(m[1].cpu())
            best.append(m[2])
        return dict(frames=0, pairs=len(ij), bad=[], idx=torch.cat(idx), acc=torch.cat(acc),
                    best=best)

    def close(self):
        self.__dict__.pop("ij", None)

    def judge(self, samples, reference) -> judge.Tally:
        tally = judge.Tally()
        pairings = {i: tally.frame(clients.frame_dict(self.kp, i), reference((i, 0)))
                    for i in range(len(self.frames))}
        valid = self.kp.valid.cpu().numpy()
        for s in samples:
            best = torch.cat(s["best"]).cpu().numpy()
            for k, (i, j) in enumerate(s["req"]["match"].tolist()):
                prog = clients.valid_order(s["idx"][k].numpy(), s["acc"][k].numpy(), best[k],
                                           valid[i], valid[j])
                tally.matches(prog, pairings[i], pairings[j], clients.plain_matches(
                    reference, (i, 0), (j, 0), self.cfg.ratio_threshold))
        return tally

    def work(self, records) -> dict:
        pairs = [(self.n_valid[i], self.n_valid[j])
                 for r in records for i, j in r["req"]["match"].tolist()]
        return dict(pair_valid=pairs)
