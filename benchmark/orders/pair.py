"""The configuration's frames 0 and 1 under one flip per request, each run
of four requests taking the four flips in an order drawn from the seed
(every seed the same work); frame 0 matched against frame 1."""

import itertools

from benchmark.traffic import rng


def requests(mix: dict, n_frames: int, seed: int):
    draw = rng(seed, 1)
    flips: list[int] = []
    for k in itertools.count(-1):
        if not flips:
            flips = draw.permutation(4).tolist()
        yield dict(index=k, frames=[0, 1], flip=flips.pop(), pairs=[(0, 1)])
