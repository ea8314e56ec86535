"""Each request's frames go to the entry point
``models/sift.detect_and_describe_batch`` as one batch, then its pairs to
``models/match.match_descriptors`` in one call, whose ``best_idx`` and
``accept`` are copied to the host.  The mix's ``source`` says where the
frames come from: ``device`` (uint8 frames uploaded in set-up, the batch
assembled on the card), ``host`` (a uint8 batch in host memory, copied by
the entry point) or ``png`` (PNG files written in set-up under the
temporary directory, read by ``utils/native.ImageLoader`` at its default
thread count and staged by ``bench.stage_batches``)."""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmark import clients, judge, traffic

# The png source writes its loader's file list in set-up: enough requests
# for this many frames a second through the window.
PNG_PLAN_FRAMES_PER_S = 1000


class Client(clients.Client):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.source = self.mix["source"]
        self.prev = None  # (Keypoints, frame) of the last frame handed over
        self.index: dict = {}
        self.tmp = self.loader = None

    def setup(self, reqs):
        """Upload or write the frames; for ``png`` the loader is given its
        files in request order."""
        if self.source == "device":
            self.on_card = torch.from_numpy(np.stack(self.frames)).to(self.dev)
        elif self.source == "host":
            self.variants = {}
        elif self.source == "png":
            from PIL import Image
            from sift_tpu_torch.bench import stage_batches
            from sift_tpu_torch.utils.native import ImageLoader

            self.tmp = tempfile.mkdtemp(prefix="sift_bench_png_")
            paths = []
            for i, f in enumerate(self.frames):
                paths.append(str(Path(self.tmp) / f"{i:02d}.png"))
                Image.fromarray(f).save(paths[-1])
            batch = self.mix["batch"]
            plan = [next(reqs) for _ in range(2 + int(self.seconds * PNG_PLAN_FRAMES_PER_S) // batch)]
            self.loader = ImageLoader([paths[i] for r in plan for i in r["frames"]])
            self.staged = stage_batches(self.loader, batch, self.dev)
            reqs = iter(plan)
        else:
            raise ValueError(f"unknown source {self.source!r}")
        return reqs

    def batch(self, req):
        if self.source == "device":
            return torch.stack([self.on_card[i] for i in req["frames"]])
        if self.source == "host":
            if req["flip"] not in self.variants:
                self.variants[req["flip"]] = np.stack(
                    [traffic.flipped(self.frames[i], req["flip"]) for i in req["frames"]])
            return self.variants[req["flip"]]
        with self.spans("loader.next", 1):
            imgs, _ = next(self.staged)
        return imgs

    def _pair_index(self, pairs, warm: bool):
        key = (tuple(pairs), warm)
        if key not in self.index:
            q = [(t if warm else q) + 1 if q < 0 else q + 1 for q, t in pairs]
            t = [t + 1 for _, t in pairs]
            self.index[key] = (torch.tensor(q, device=self.dev), torch.tensor(t, device=self.dev))
        return self.index[key]

    def request(self, req) -> dict:
        imgs = self.batch(req)
        n = len(req["frames"])
        with self.spans("entry", n):
            kp, counts = self.detect(imgs, self.cfg, return_counts=True, device=self.dev)
        pairs = req["pairs"]
        with self.spans("match", len(pairs)):
            warm = self.prev is None
            first = (self.prev[0].desc[self.prev[1]], self.prev[0].valid[self.prev[1]]) if not warm \
                else (kp.desc[0], kp.valid[0])
            desc = torch.cat([first[0][None], kp.desc])
            valid = torch.cat([first[1][None], kp.valid])
            q, t = self._pair_index(pairs, warm)
            idx, acc, best, _ = self.match(desc[q], valid[q], desc[t], valid[t],
                                           self.cfg.ratio_threshold, device=self.dev)
            idx, acc = idx.cpu(), acc.cpu()
        with self.spans("check"):
            bad = clients.clipped(counts, self.cfg)
        out = dict(frames=n, pairs=len(pairs), bad=bad, kp=kp, prev=self.prev, idx=idx, acc=acc,
                   best=best, staged=imgs if self.source == "png" else None)
        self.prev = (kp, n - 1)
        return out

    def close(self):
        if self.loader is not None:
            self.loader.close()
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
        self.__dict__.pop("on_card", None)
        self.__dict__.pop("staged", None)
        self.prev = None

    def judge(self, samples, reference) -> judge.Tally:
        tally = judge.Tally()
        for s in samples:
            req = s["req"]
            n = len(req["frames"])
            keys = {f: (req["frames"][f], req["flip"]) for f in range(n)}
            views = {f: (s["kp"], f) for f in range(n)}
            if any(q < 0 for q, _ in req["pairs"]):
                keys[-1] = (s["prev_req"]["frames"][-1], s["prev_req"]["flip"])
                views[-1] = s["prev"]
            pairing = {}
            for f in keys:
                prog = clients.frame_dict(*views[f])
                # the frame before the request is judged in its own request
                pairing[f] = (tally.frame(prog, reference(keys[f])) if f >= 0
                              else judge.pair_keypoints(prog, reference(keys[f])))
            for k, (q, t) in enumerate(req["pairs"]):
                v1, v2 = (views[f][0].valid[views[f][1]].cpu().numpy() for f in (q, t))
                prog = clients.valid_order(s["idx"][k].numpy(), s["acc"][k].numpy(),
                                           s["best"][k].cpu().numpy(), v1, v2)
                tally.matches(prog, pairing[q], pairing[t], clients.plain_matches(
                    reference, keys[q], keys[t], self.cfg.ratio_threshold))
            if s["staged"] is not None:
                handed = np.stack([self.frames[i] for i in req["frames"]])
                tally.pixels(s["staged"].cpu().numpy(), handed)
        return tally

    def work(self, records) -> dict:
        return dict(frame_shape=self.frames[0].shape, frames=sum(r["frames"] for r in records))
