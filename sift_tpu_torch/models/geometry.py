"""Multi-view geometry primitives (the JAX package's ``models/geometry.py``).

Only the least-squares null vector is ported so far: the stitching slice's
homography refit needs it.  The rest (rodrigues, triangulation, essential
matrices, pose RANSAC) belongs to the SfM slice (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch


def min_eigvec(a: torch.Tensor) -> torch.Tensor:
    """Least-squares null vector of (..., M, D) via the D x D normal
    equations and ``eigh``: the eigenvector of the smallest eigenvalue, the
    same minimizer as the SVD null vector.  Its sign is arbitrary.

    The normal matrix is a sum of elementwise products, not a BLAS product:
    a CPU BLAS may round the same product differently from call to call
    (its code path follows the operands' alignment), and RANSAC's choice
    between near-tied hypotheses must not move with it.
    """
    ata = (a[..., :, :, None] * a[..., :, None, :]).sum(-3)
    _, vecs = torch.linalg.eigh(ata)
    return vecs[..., :, 0]
