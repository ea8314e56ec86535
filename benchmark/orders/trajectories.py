"""Each request one whole sequence of a camera trajectory: the mix's
``trajectories`` trajectories, their seeds drawn from the run's seed (every
request carries them, so set-up can render every sequence before the
first), each run of that many requests taking them all in an order drawn
from the seed.  A request's ``frames`` are the sequence's frames, not the
configuration's (its textures)."""

import itertools

from benchmark.traffic import rng


def requests(mix: dict, n_frames: int, seed: int):
    draw = rng(seed, 3)
    n = mix["trajectories"]
    seeds = [int(s) for s in draw.integers(0, 2**62, n)]
    length = 2 * mix["outward"] - 2
    order: list[int] = []
    for k in itertools.count(-1):
        if not order:
            order = draw.permutation(n).tolist()
        yield dict(index=k, trajectory=order.pop(), seeds=seeds, frames=list(range(length)),
                   flip=0, pairs=[])
