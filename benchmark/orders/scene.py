"""Every frame of the configuration, in order, as one scene under one flip
per request, each run of four requests taking the four flips in an order
drawn from the seed (every seed the same work).  The scene's pairs are
its stitching graph's, which the client builds."""

import itertools

from benchmark.traffic import rng


def requests(mix: dict, n_frames: int, seed: int):
    draw = rng(seed, 3)
    flips: list[int] = []
    for k in itertools.count(-1):
        if not flips:
            flips = draw.permutation(4).tolist()
        yield dict(index=k, frames=list(range(n_frames)), flip=flips.pop(), pairs=[])
