"""Exact-rounding helpers and the device rule.

PyTorch runs every elementwise op as its own kernel, so products and sums
round separately (no FMA contraction) on the CPU and on the card.  One trap
remains: on CUDA, dividing a tensor by a Python number multiplies by the
reciprocal instead.  ``xdiv`` divides by a 0-dim tensor on the operand's own
device, which is a true IEEE division everywhere.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.utils import profiling


def xmul(a, b):
    """A product rounded on its own, as the C++ reference rounds it.  Every
    PyTorch elementwise op is its own kernel, so nothing fuses it into a
    multiply-add and no barrier is needed (the JAX helper hides float64
    products from XLA's contraction)."""
    return a * b


def xdiv(a: torch.Tensor, b) -> torch.Tensor:
    """True division, also when ``b`` is a constant."""
    if not isinstance(b, torch.Tensor):
        with profiling.span("sift.sync.table"):
            b = torch.tensor(b, dtype=a.dtype, device=a.device)
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
