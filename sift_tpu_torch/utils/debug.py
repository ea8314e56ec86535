"""Numerical-safety tooling (the rebuild's answer to the reference's ASan
debug build, Makefile:6).

Counterpart of ``sift_tpu/utils/debug.py``.  The reference's only
correctness tool was AddressSanitizer; NaNs from its unguarded divisions
(src/sift.cpp:88-98, 586-597) propagate silently.  Here:

  - ``checked(fn)`` runs ``fn`` under a ``TorchDispatchMode`` that raises
    ``FloatingPointError`` at the first op that turns finite inputs into
    NaN or inf, and ``IndexError`` before an indexing op whose indices are
    out of bounds (on a card such an index is a device-side assert that
    ends the CUDA context) -- the port of checkify's float and index
    checks.
  - ``assert_finite(tree)`` validates pipeline outputs host-side.
  - ``nan_debug()`` turns the same NaN / inf check on for a scope.

Each checked op reads its values back, so a checked call waits for the
card at every op: a debugging tool, not a production path.  The kernels'
plain versions (ops/*) are their correctness reference.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from sift_tpu_torch.utils.keypoints import FIELDS, Keypoints

aten = torch.ops.aten
# Ops whose output holds whatever memory held: nothing to check.
_UNINITIALIZED = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex()) or bool(torch.isfinite(x).all())
    return not isinstance(x, float) or bool(np.isfinite(x))


def _check_indices(func, args):
    """IndexError if an indexing op's indices leave its source's bounds
    (negative indices count from the end where the op allows them)."""
    src = args[0]
    if func is aten.index.Tensor:
        pos = 0
        for idx in args[1]:
            if idx is not None and idx.dtype in (torch.bool, torch.uint8):
                pos += idx.dim()
                continue
            if idx is not None:
                _in_bounds(idx, src.shape[pos], True, func)
            pos += 1
    elif func in (aten.index_select.default, aten.gather.default):
        _in_bounds(args[2], src.shape[args[1]], False, func)
    elif func is aten.take.default:
        _in_bounds(args[1], src.numel(), True, func)


def _in_bounds(idx: torch.Tensor, n: int, negative: bool, func):
    if idx.numel() == 0:
        return
    lo, hi = int(idx.min()), int(idx.max())
    if hi >= n or lo < (-n if negative else 0):
        raise IndexError(f"{func}: index out of bounds [{lo}, {hi}] for size {n}")


class _Checks(TorchDispatchMode):
    def __init__(self, index_checks: bool):
        super().__init__()
        self.index_checks = index_checks

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.index_checks:
            _check_indices(func, args)
        inputs_finite = all(_finite(a) for a in tree_flatten((args, kwargs))[0])
        out = func(*args, **kwargs)
        if inputs_finite and func.overloadpacket.__name__ not in _UNINITIALIZED:
            for o in tree_flatten(out)[0]:
                if not _finite(o):
                    raise FloatingPointError(f"{func} produced NaN or inf from finite inputs")
        return out


def checked(fn):
    """Wrap ``fn`` so that NaN / inf production and out-of-bounds indexing
    inside it raise instead of propagating (same signature)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _Checks(index_checks=True):
            return fn(*args, **kwargs)

    return wrapper


def tree_leaves(tree, path: str = ""):
    """(path, leaf) of each leaf of Keypoints, dicts, lists and tuples, the
    path as JAX's ``keystr`` writes it (``.x``, ``['a']``, ``[0]``)."""
    if isinstance(tree, Keypoints):
        for f in FIELDS:
            yield from tree_leaves(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_finite(tree, name: str = "output") -> None:
    """Host-side validation that every float leaf is finite; the error
    names the leaf."""
    for path, leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if arr.dtype.kind in "fc" and not np.isfinite(arr).all():
            raise FloatingPointError(f"{name}{path} contains non-finite values")


@contextlib.contextmanager
def nan_debug():
    """Raise at the first op that produces NaN or inf within the scope (the
    JAX package's ``jax_debug_nans`` scope)."""
    with _Checks(index_checks=False):
        yield
