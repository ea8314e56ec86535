"""Exact-rounding helpers and the device rule.

PyTorch runs every elementwise op as its own kernel, so products and sums
round separately (no FMA contraction) on the CPU and on the card.  One trap
remains: on CUDA, dividing a tensor by a Python number multiplies by the
reciprocal instead.  ``xdiv`` divides by a 0-dim tensor on the operand's own
device, which is a true IEEE division everywhere.

``device_const`` is the one place a host constant reaches the card: built
once per process for each value, dtype and device.
"""

from __future__ import annotations

import functools

import torch

from sift_tpu_torch.utils import profiling


def xmul(a, b):
    """A product rounded on its own, as the C++ reference rounds it.  Every
    PyTorch elementwise op is its own kernel, so nothing fuses it into a
    multiply-add and no barrier is needed (the JAX helper hides float64
    products from XLA's contraction)."""
    return a * b


def device_const(values, dtype, device) -> torch.Tensor:
    """A read-only device tensor of a Python scalar (0-dim) or a flat
    sequence, converted to ``dtype``.  Building one from host values waits
    for the card (``sift.sync.table``), so each is built once per process
    and kept: the cache keys on the values and their ``repr`` (exact for
    Python and NumPy numbers, so 0.0 and -0.0 differ), the dtype and the
    device.  Callers never write to it."""
    if isinstance(values, list):
        values = tuple(values)
    return _built(repr(values), values, dtype, device)


@functools.lru_cache(maxsize=1024)
def _built(key: str, values, dtype, device) -> torch.Tensor:
    with profiling.span("sift.sync.table"):
        return torch.tensor(values, dtype=dtype, device=device)


def xdiv(a: torch.Tensor, b) -> torch.Tensor:
    """True division, also when ``b`` is a constant."""
    if not isinstance(b, torch.Tensor):
        b = device_const(b, a.dtype, a.device)
    return a / b


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C++ ``std::round``: round half away from zero."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Float -> int32 with XLA's conversion semantics: NaN -> 0, saturate.

    Only degenerate Newton lanes (singular Hessian) ever carry such values;
    the saturation bound keeps ``pos + step`` far outside every image.
    """
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0**30, neginf=-(2.0**30))
    return x.clamp(-(2.0**30), 2.0**30).to(torch.int32)


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the CPU.

    A CUDA request on a machine without a CUDA device raises; there is no
    silent fallback to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sift_tpu_torch: no CUDA device; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
