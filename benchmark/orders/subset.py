"""Every unordered pair of ``collection`` frames drawn from the seed
without replacement, in ascending order, as ``match``."""

import itertools

import numpy as np

from benchmark.traffic import rng


def requests(mix: dict, n_frames: int, seed: int):
    draw = rng(seed, 2)
    upper = np.triu_indices(mix["collection"], 1)
    for k in itertools.count(-1):
        sub = np.sort(draw.choice(n_frames, mix["collection"], replace=False))
        yield dict(index=k, frames=sub.tolist(), flip=0, pairs=[],
                   match=np.stack([sub[upper[0]], sub[upper[1]]], axis=1))
