"""``batch`` consecutive frames of a ping-pong walk through the frames (0,
1, ..., n-1, n-2, ..., 1, 0, ...), the seed picking the start and the
direction; every frame is matched against the one before it."""

import itertools

from benchmark.traffic import rng


def walk_frames(n: int, seed: int):
    """The walk's frame at each step: ``f(step)``."""
    period = 2 * (n - 1)
    draw = rng(seed, 0)
    start, forward = int(draw.integers(period)), bool(draw.integers(2))
    cycle = list(range(n)) + list(range(n - 2, 0, -1))
    if not forward:
        cycle = cycle[::-1]
    return lambda step: cycle[(start + step) % period]


def requests(mix: dict, n_frames: int, seed: int):
    batch = mix["batch"]
    at = walk_frames(n_frames, seed)
    for k in itertools.count(-1):
        yield dict(index=k, frames=[at(k * batch + i) for i in range(batch)], flip=0,
                   pairs=[(i - 1, i) for i in range(batch)])
