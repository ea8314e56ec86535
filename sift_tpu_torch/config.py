"""Configuration of the PyTorch/CUDA SIFT pipeline.

The knobs and their derived host-side math are the same as the JAX
package's ``sift_tpu.config`` (reference defaults: src/sift.hh:65-75); this
module keeps its own copy so that the port never imports the JAX package.
Every derived quantity is pure Python float64 math in the reference's
order, so the float64 parity profile reproduces the C++ binary bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# Compile-time constants from the reference (src/sift.hh:5-13).
M_PI2 = 6.283185307179586
MAX_CONVERGENCE_STEPS = 5
CONVERGENCE_THR = 0.5
ORI_SMOOTH_ITERATIONS = 2
DESC_HIST_WIDTH = 4
DESC_HIST_BINS = 8
DESC_MAGNITUDE_THR = 0.2
INT_DESCR_FCTR = 512.0

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_RENAMED = {"use_pallas_pyramid": "use_octave_kernel"}


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """All SIFT pipeline knobs.

    Capacities are global (all octaves of one image): every dynamically
    sized collection of the reference becomes a fixed-capacity lane buffer
    with a validity mask, and the true per-stage counts returned by
    ``detect_and_describe_batch(..., return_counts=True)`` show whether a
    capacity clipped real detections.
    """

    double_image_size: bool = True
    init_sigma: float = 1.6
    intervals: int = 3
    window_size: int = 3
    contrast_threshold: float = 0.04
    eigen_ratio: float = 10.0
    num_bins: int = 36
    peak_ratio: float = 0.8
    ori_sigma_factor: float = 1.5
    desc_scale_factor: float = 3.0
    ratio_threshold: float = 0.75

    extrema_cap: int = 8192
    kp_cap: int = 4096
    ori_cap: int = 8192
    # None: the cascade schedule of models.detect.refine_cascade_caps.
    refine_active_cap: int | None = None
    # Orientation candidates kept per keypoint (strict local maxima over 36
    # bins allow at most 18; real images peak at 3-4).  The honesty counter
    # ``ori_slots_max`` reports when a keypoint had more.
    ori_cand_slots: int = 8

    # float32 is the card's profile; float64 on the CPU is the bit-parity
    # profile held against the C++ reference.
    dtype: torch.dtype = torch.float32

    # Route knob, the counterpart of the JAX package's use_pallas_pyramid.
    # None: auto, True: the octave kernels, False: the blur chain.  Auto
    # resolves on for float32 tensors on CUDA (``kernel_on``).  On: a whole
    # octave through kernel C (ops/octave_blur.py) in build_pyramids, and
    # with window_size 3 in float32 the front route (models/sift.use_front).
    # Off: every blur of the chain through kernel D (ops/blur_pass.py).
    use_octave_kernel: bool | None = None

    @staticmethod
    def from_reference(fields: dict) -> "SiftConfig":
        """Build a config from ``dataclasses.asdict`` of the JAX SiftConfig.

        ``dtype`` may be given by name (``"float32"``/``"float64"``) or as
        any object whose ``str`` is such a name (a numpy dtype); the JAX
        package's ``use_pallas_pyramid`` becomes ``use_octave_kernel``.
        ``use_pallas_blur`` needs no knob: every value of it gives the port
        the same result, since the port's one float32 blur on the card is
        kernel D, bit-equal to the plain blur of the CPU and float64 (the JAX
        package leaves its blur kernel off by default only for its compile
        time on the TPU).  Other fields the port does not have are dropped.
        """
        names = {f.name for f in dataclasses.fields(SiftConfig)}
        fields = {_RENAMED.get(k, k): v for k, v in fields.items()}
        kw = {k: v for k, v in fields.items() if k in names}
        if "dtype" in kw and not isinstance(kw["dtype"], torch.dtype):
            dt = kw["dtype"]
            name = getattr(dt, "__name__", None) or str(dt)
            kw["dtype"] = _DTYPES[name.replace("torch.", "")]
        return SiftConfig(**kw)

    def gaussian_kernels(self) -> list[float]:
        """Incremental blur sigmas (reference: src/sift.cpp:143-155)."""
        n = self.intervals + 3
        ks = [0.0] * n
        ks[0] = self.init_sigma
        k = math.pow(2.0, 1.0 / self.intervals)
        for i in range(1, n):
            sigma_prev = math.pow(k, i - 1) * self.init_sigma
            ks[i] = sigma_prev * math.sqrt(k * k - 1)
        return ks

    def octaves_count(self, width: int, height: int) -> int:
        """Number of octaves (src/sift.cpp:132-137, C++ ``min_size / 3``)."""
        min_size = min(width, height)
        return int(math.floor(math.log2(min_size // 3)))

    def extrema_cap_for_octave(self, octave: int) -> int:
        """The staged path's per-octave capacities: octave 0's, halved per
        octave, with a floor."""
        return max(self.extrema_cap >> octave, 256)

    def kp_cap_for_octave(self, octave: int) -> int:
        return max(self.kp_cap >> octave, 128)

    def extremum_threshold(self) -> float:
        """Pre-filter threshold (src/sift.cpp:305-307, "OpenCV formula")."""
        return math.floor(
            0.5 * self.contrast_threshold / float(self.intervals) * 255.0
        )


def kernel_on(knob: bool | None, dtype: torch.dtype, device) -> bool:
    """Resolve a route knob for data of ``dtype`` on ``device``: the kernels
    take float32 only (like the JAX package's fits predicates); auto means
    "on the card"."""
    if dtype != torch.float32 or knob is False:
        return False
    return knob is True or torch.device(device).type == "cuda"


def gaussian_half_kernel(sigma: float) -> list[float]:
    """One-sided gaussian taps as the reference builds them
    (src/image.cpp:226-235), unnormalized; the blur divides by ``sum_w``."""
    size = int(math.ceil(3 * sigma)) + 1
    exp_denom = 2 * sigma * sigma
    coef = 1 / (math.sqrt(2 * math.pi) * sigma)
    return [math.exp(-(i * i) / exp_denom) * coef for i in range(size)]


def half_kernel_weight_sum(kernel: list[float]) -> float:
    """The constant ``sum_w`` of the reference conv (src/image.cpp:170-184):
    k0 + 2*k1 + ... in this exact order."""
    s = kernel[0]
    for u in range(1, len(kernel)):
        s += 2.0 * kernel[u]
    return s
