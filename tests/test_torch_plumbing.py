"""Host-to-card plumbing on the CPU: ``numerics.device_const`` builds a
constant once per value, dtype and device (the one ``sift.sync.table``
span), ``xdiv`` by such a constant is a true division, and
``kernels.check`` counts each hand-written kernel's launches."""

from __future__ import annotations

import pytest
import torch

from sift_tpu_torch import kernels
from sift_tpu_torch.ops.top2 import top2
from sift_tpu_torch.utils.numerics import device_const, xdiv

KERNELS = ("octave_front", "top2", "octave_blur", "blur_pass", "twin_rows", "octave_front_twin",
           "cube_pack", "twin_rows_2d", "describe", "detect")


def tables(fn):
    """(fn's result, the ``sift.sync.table`` spans it opened)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.name == "sift.sync.table" for e in prof.events())


def test_a_constant_is_built_once():
    vals = (0.1875, -3.0625, 1e-7)  # values no other caller builds
    first, built = tables(lambda: device_const(vals, torch.float64, "cpu"))
    again, rebuilt = tables(lambda: device_const(list(vals), torch.float64, "cpu"))
    assert again is first and (built, rebuilt) == (1, 0)
    assert first.dtype == torch.float64 and first.tolist() == list(vals)
    assert device_const(vals, torch.float32, "cpu") is not first
    assert device_const(2.5, torch.float32, "cpu").shape == ()
    # keyed on each value as written: -0.0 is its own constant
    neg, pos = device_const(-0.0, torch.float32, "cpu"), device_const(0.0, torch.float32, "cpu")
    assert neg is not pos and torch.signbit(neg) and not torch.signbit(pos)


@pytest.mark.parametrize("dtype,bits", [(torch.float32, torch.int32),
                                        (torch.float64, torch.int64)])
def test_xdiv_by_a_cached_divisor_is_true_division(dtype, bits):
    a = torch.randn(4096, generator=torch.Generator().manual_seed(0), dtype=dtype) * 1e3
    for b in (3.0, 0.1, 14.5, 255.0, 7.0 / 3.0):
        want = a / torch.tensor(b, dtype=dtype)
        for _ in range(2):  # the build, then the cached tensor
            assert torch.equal(xdiv(a, b).view(bits), want.view(bits)), b


def test_launch_counts_move_only_on_a_launch():
    kernels.reset_launch_counts()
    zero = kernels.launch_counts()
    assert tuple(zero) == KERNELS and set(zero.values()) == {0}
    d = torch.zeros((1, 4, 128), dtype=torch.uint8)
    top2(d, d, torch.ones((1, 4), dtype=torch.bool))  # a CPU tensor: the plain version
    kernels.check(0, "blur_plan")  # a helper call of kernel D's library, no launch
    with pytest.raises(RuntimeError, match="top2: CUDA error 1"):
        kernels.check(1, "top2")
    assert kernels.launch_counts() == zero
    for name in ("top2", "detect", "detect"):
        kernels.check(0, name)
    got = kernels.launch_counts()
    assert got == {**zero, "top2": 1, "detect": 2}
    got["top2"] = 99  # a copy
    assert kernels.launch_counts()["top2"] == 1
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == zero
