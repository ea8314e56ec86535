"""Exact-integer top-2 of squared L2 descriptor distances.

``top2`` is the wrapper of kernel B (``csrc/top2.cu``), the port of the TPU
kernel ``sift_tpu/ops/pallas_match.py::pallas_top2``; ``top2_plain`` is its
plain PyTorch version: a d^2 matrix from one matmul (float64 on the CPU,
float32 with TF32 off on the card -- exact either way, every partial sum is
an integer below 2^24), then argmin and a masked min.
"""

from __future__ import annotations

import ctypes

import torch

from sift_tpu_torch import kernels

# Larger than any squared distance (< 2^23) with 16 * HUGE inside int32.
HUGE_D2 = 1 << 24


def top2_plain(desc1, desc2, valid2):
    """desc1 (P, N, 128) u8, desc2 (P, M, 128) u8, valid2 (P, M) bool ->
    (best, second, idx) int32 (P, N).  First column wins ties; duplicates of
    the best count as second; invalid columns read HUGE_D2."""
    dt = torch.float64 if desc1.device.type == "cpu" else torch.float32
    a = desc1.to(dt)
    b = desc2.to(dt)
    g = a @ b.transpose(-1, -2)
    na = (a * a).sum(-1)
    nb = (b * b).sum(-1)
    d2 = (na[..., :, None] + nb[..., None, :] - 2.0 * g).to(torch.int32)
    huge = torch.tensor(HUGE_D2, dtype=torch.int32, device=d2.device)
    d2 = torch.where(valid2[..., None, :].bool(), d2, huge)
    idx = torch.argmin(d2, dim=-1)
    best = torch.gather(d2, -1, idx[..., None])[..., 0]
    cols = torch.arange(d2.shape[-1], device=d2.device)
    second = torch.where(cols == idx[..., None], huge, d2).amin(-1)
    return best, second, idx.to(torch.int32)


def top2(desc1, desc2, valid2):
    """Same contract as ``top2_plain``; kernel B on CUDA tensors."""
    if desc1.device.type == "cpu":
        return top2_plain(desc1, desc2, valid2)
    if desc1.device.type != "cuda":
        raise ValueError(f"top2: unsupported device {desc1.device}")
    for t, name in ((desc1, "desc1"), (desc2, "desc2")):
        if t.dtype != torch.uint8 or t.dim() != 3 or t.shape[-1] != 128:
            raise ValueError(f"top2: {name} must be (P, n, 128) uint8")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"top2: {name} must be contiguous and 16-byte aligned")
        if t.device != desc1.device:
            raise ValueError("top2: inputs on different devices")
    pn, n = desc1.shape[:2]
    m = desc2.shape[1]
    if desc2.shape[0] != pn or tuple(valid2.shape) != (pn, m):
        raise ValueError("top2: shapes disagree")
    if valid2.dtype not in (torch.bool, torch.uint8) or valid2.device != desc1.device:
        raise ValueError("top2: valid2 must be bool/uint8 on the same device")
    valid2 = valid2.contiguous()
    out = [torch.empty((pn, n), dtype=torch.int32, device=desc1.device) for _ in range(3)]
    fn = _launcher()
    with torch.cuda.device(desc1.device):
        stream = torch.cuda.current_stream(desc1.device).cuda_stream
        err = fn(
            desc1.data_ptr(), desc2.data_ptr(), valid2.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            pn, n, m, stream,
        )
    kernels.check(err, "top2")
    top2.launches += 1
    return tuple(out)


top2.launches = 0


def _launcher():
    fn = kernels.load("top2").top2_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, p]
    fn.restype = i
    return fn
