"""Distributed pipeline stages: data-parallel detection, sharded matching.

Counterpart of ``sift_tpu/parallel/dist.py`` (SURVEY.md section 2.7): the
reference's two sequential detect calls (src/main.cpp:14-15) become a batch
split over the ``data`` mesh axis; the O(N*M) brute-force matcher
(src/sift.cpp:783-815) shards the B-side descriptors over the ``kp`` axis --
each rank computes a local top-2 with kernel B, then the global top-2
merges the ranks' candidates gathered over ``kp``.  Tie-breaking stays
bit-faithful: the merge compares (distance, shard) lexicographically, and
shards cover ascending global index ranges, which equals the reference's
first-index-wins scan order.

Every function is called on every rank of the mesh with the same
arguments and returns the same global result on every rank
(``parallel/mesh.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.models.match import ratio_accept
from sift_tpu_torch.models.sift import as_batch, route_of, run_route
from sift_tpu_torch.ops.top2 import HUGE_D2, top2
from sift_tpu_torch.parallel.mesh import all_gather, axis_index, axis_size, mesh_device
from sift_tpu_torch.utils.keypoints import Keypoints


def batched_detect(images, cfg: SiftConfig, octaves: int, mesh: DeviceMesh) -> Keypoints:
    """Detect + describe a (B, H, W[, C]) batch, B split over the ``data``
    axis: each ``data`` rank runs its contiguous share of B / n images
    through the port's batch route (on the card the front-twin route,
    kernels D and F); ranks that share a ``data`` index detect the same
    share, as the JAX package replicates over ``kp``.  The shares are
    gathered over ``data``: every rank returns Keypoints with leading B.
    """
    dev = mesh_device(mesh)
    n, i = axis_size(mesh, "data"), axis_index(mesh, "data")
    bsz = len(images)
    if bsz % n:
        raise ValueError(f"batch {bsz} does not divide the data axis ({n})")
    share = bsz // n
    imgs = as_batch(images[i * share: (i + 1) * share], cfg, dev)
    out, _ = run_route(imgs, cfg, route_of(cfg, dev), octaves=octaves)
    return out.map(lambda a: all_gather(a, mesh, "data").reshape(bsz, *a.shape[1:]))


def sharded_match(desc1, valid1, desc2, valid2, mesh: DeviceMesh,
                  ratio_threshold: float = 0.75):
    """Lowe-ratio matching with the B side sharded over the ``kp`` axis:
    (best_idx, accept, best_d2, second_d2), bit for bit what
    ``models.match.match_descriptors`` gives (see tests).

    Inputs as ``match_descriptors`` takes them: (N, 128) / (N,) for one
    pair, or (P, N, 128) / (P, N) for P pairs.  Each ``kp`` rank takes its
    M / nkp B-side rows (M must divide the axis): kernel B on the card.
    """
    dev = mesh_device(mesh)
    d1, v1, d2, v2 = (torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(dev)
                      for a in (desc1, valid1, desc2, valid2))
    single = d1.dim() == 2
    if single:
        d1, v1, d2, v2 = d1[None], v1[None], d2[None], v2[None]
    nkp, shard = axis_size(mesh, "kp"), axis_index(mesh, "kp")
    m = d2.shape[1]
    if m % nkp:
        raise ValueError(f"B-side capacity {m} must divide the kp axis ({nkp})")
    w = m // nkp
    cols = slice(shard * w, (shard + 1) * w)
    best, second, bidx = top2(d1.to(torch.uint8).contiguous(),
                              d2[:, cols].to(torch.uint8).contiguous(),
                              v2[:, cols].bool().contiguous())
    # Global index = local column + shard offset.  The offset is the B-side
    # SHARD WIDTH (m / nkp), not the 128-wide descriptor dimension: the two
    # coincide only when m / nkp == 128, so tests use another width.
    gidx = bidx + shard * w
    bests, seconds, gidxs = (all_gather(t, mesh, "kp") for t in (best, second, gidx))

    # Global best: the lowest distance, the lowest shard on ties (shards
    # cover ascending index ranges: the reference's first-index-wins order).
    g_best, g_idx = bests[0], gidxs[0]
    win = torch.zeros_like(g_best)
    for k in range(1, nkp):
        lt = bests[k] < g_best
        g_best = torch.where(lt, bests[k], g_best)
        g_idx = torch.where(lt, gidxs[k], g_idx)
        win = torch.where(lt, k, win)
    # Global second: the least of the other shards' bests (a duplicate of
    # the best distance counts, src/sift.cpp:803) and of every second.
    shards = torch.arange(nkp, device=dev).reshape(nkp, 1, 1)
    others = torch.where(shards == win, HUGE_D2, bests)
    g_second = torch.minimum(others.amin(0), seconds.amin(0))
    accept = ratio_accept(g_best, g_second, v1.bool(), ratio_threshold)
    out = (g_idx, accept, g_best, g_second)
    return tuple(o[0] for o in out) if single else out
