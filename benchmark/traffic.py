"""What the traffic orders share.  A mix (``traffic/<mix>.json``) names its
``order``, the module ``orders/<order>.py`` whose ``requests(mix,
n_frames, seed)`` yields the run's requests from ``--seed``, and its
``client``, the module ``clients/<client>.py`` that hands them to the
program; both are found by name, so a new kind of traffic is a new file.

A request is a dict: ``index`` (-1 for the warm-up, which set-up runs,
then 0, 1, 2, ...), ``frames`` (indices into the configuration's frames,
handed to the entry point as one batch), ``flip`` (0 none, 1 left-right, 2
up-down, 3 both; applied to every frame of the request), ``pairs``
((query, target) positions into the request's frames, -1 meaning the last
frame of the request before) and, for a mix that matches features
extracted in set-up, ``match`` (a (pairs, 2) array of frame indices).  The
same seed gives the same requests.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def flipped(frame: np.ndarray, flip: int) -> np.ndarray:
    """A (H, W, C) frame under ``flip`` (bit 0: left-right, bit 1: up-down)."""
    if flip & 1:
        frame = frame[:, ::-1]
    if flip & 2:
        frame = frame[::-1]
    return np.ascontiguousarray(frame)
