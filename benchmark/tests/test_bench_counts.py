"""The work counts, worked by hand at small shapes, and the import rule:
nothing the harness imports is JAX or the JAX package (whole top-level
names: the port's own name begins with the JAX package's)."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.counts import PEAKS, kernel_B, kernel_F

ROOT = Path(__file__).resolve().parents[2]


def test_kernel_b_counts_valid_descriptors_only():
    nbytes, ops = kernel_B.work(3, 5)
    assert ops == 2 * 128 * 3 * 5 == 3840
    assert nbytes == 128 * 8 + 12 * 3 == 1060
    # ops-bound at these peaks: 1000 x 1000 descriptors
    assert kernel_B.least([(1000, 1000)]) == pytest.approx(2.56e8 / PEAKS["int8_ops_per_s"])
    assert kernel_B.least([(1000, 1000), (0, 7)]) == pytest.approx(2.56e8 / PEAKS["int8_ops_per_s"])


def test_kernel_f_counts_dense_planes():
    """A 12 x 16 frame doubled to 24 x 32: octaves 24 x 32 (min 24 // 3 =
    8: three octaves), 12 x 16, 6 x 8.  The chain's taps are 5, 6, 7, 9,
    11: 28 + 34 + 40 + 52 + 64 blur operations, 5 subtractions, 3 x 55 for
    the masks: 388 a pixel."""
    assert kernel_F.octaves(12, 16, {}) == [(24, 32), (12, 16), (6, 8)]
    nbytes, ops = kernel_F.work(12, 16, {})
    px = 24 * 32 + 12 * 16 + 6 * 8
    assert ops == 388 * px
    planes = 1 + 3 + 5  # seed, gauss 1..3, 5 DoGs in float32
    masks = 3  # a byte a pixel each
    counts = 4 * 3 * (24 + 12 + 6)  # one 128-lane block a row
    down = 4 * (12 * 16 + 6 * 8 + 3 * 4)
    assert nbytes == 4 * planes * px + masks * px + counts + down


def test_kernel_f_skips_fallback_octaves():
    assert kernel_F.work(8, 10000, {})[0] < kernel_F.work(8, 9000, {})[0] * 10000 / 9000


def test_nothing_imported_is_jax_or_the_jax_package():
    code = ("import sys; import benchmark.run, benchmark.harness, benchmark.control, "
            "benchmark.trace, benchmark.counts.kernel_F, benchmark.counts.kernel_B, "
            "benchmark.clients.detect_match, benchmark.clients.match_only, "
            "benchmark.orders.walk, benchmark.orders.pair, benchmark.orders.subset; "
            "import sift_tpu_torch.models.sift, sift_tpu_torch.models.match, "
            "sift_tpu_torch.bench, sift_tpu_torch.utils.native; "
            "from benchmark import harness; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "sift_tpu"}, tops & {"jax", "sift_tpu"}
    assert "sift_tpu_torch" in tops


def test_the_harness_source_names_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for line in text.splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in {"jax", "jaxlib", "flax", "sift_tpu", "bench"}, (path, line)
