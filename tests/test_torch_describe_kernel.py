"""Kernel I on the card (``csrc/describe.cu``, wrapper ``ops/describe.py``).

Every test here needs an NVIDIA card and skips without one.  The suite's
``conftest.py`` imports JAX, which this file does not need, so on the
card's machine run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_describe_kernel.py

The kernel is held bit for bit to ``describe_ordered_plain`` (its order of
sums in plain PyTorch, run on the card) on the main path's gauss space of
the benchmark's two cells, to itself across launches and routes, and to
the plain chain up to that order.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from sift_tpu_torch import SiftConfig
from sift_tpu_torch.models import descriptor as De
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.models.sift import detect_stages, octaves_for
from sift_tpu_torch.ops import describe as D
from sift_tpu_torch.utils.keypoints import FIELDS

pytestmark = pytest.mark.cuda
DATA = pathlib.Path(__file__).parent / "data"
# The benchmark's cells: cave_vga (16 frames of CAVE-01, 12288 / 2048 /
# 3072) and demo_pair (the reference README's pair, SiftConfig()).
CELLS = dict(
    resident16=([DATA / "scene_oracle" / f"cave01_{i:02d}.npz" for i in range(16)],
                dict(extrema_cap=12288, kp_cap=2048, ori_cap=3072)),
    demo_pair=([DATA / f"oracle_demo{i}.npz" for i in (1, 2)], {}),
)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("kernel I runs only on an NVIDIA card: no CUDA device here")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module", params=list(CELLS))
def main_path(request, dev):
    """The front-twin route's gauss space and post-dedup keypoints of a
    cell's frames."""
    paths, caps = CELLS[request.param]
    cfg = SiftConfig(**caps)
    imgs = S.as_batch(np.stack([np.load(p)["input"] for p in paths]), cfg, dev)
    gsp, dsp, masks, counts = S.front_twin(imgs, cfg)
    kp, _ = S.detect_refine(dsp, masks, counts, cfg)
    allkp = S.dedup(S.orient(gsp, kp, cfg)[0], cfg)
    assert int(allkp.valid.sum()) > 0
    return cfg, gsp, allkp


def test_kernel_equals_the_order_model(main_path):
    """One launch through ``compute_descriptors_all`` gives
    ``describe_ordered_plain``'s bytes on every lane.  Tolerance: none."""
    cfg, gsp, allkp = main_path
    before = D.describe_kernel.launches
    got = De.compute_descriptors_all(gsp, allkp, cfg)
    assert D.describe_kernel.launches == before + 1
    want = D.describe_ordered_plain(gsp, allkp, cfg, De.desc_radius_classes(cfg))
    assert torch.equal(got, want)


def test_two_launches_give_the_same_bytes(main_path):
    cfg, gsp, allkp = main_path
    a = De.compute_descriptors_all(gsp, allkp, cfg)
    b = De.compute_descriptors_all(gsp, allkp, cfg)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_kernel_is_the_plain_chain_up_to_the_order_of_sums(main_path):
    """Against the plain chain on the card (``bmm`` per radius class):
    at most 0.1% of the valid lanes' bytes off, each by at most 1 (the
    order of float32 sums alone differs)."""
    cfg, gsp, allkp = main_path
    got = De.compute_descriptors_all(gsp, allkp, cfg)
    plain = De.compute_descriptors_plain(gsp, allkp, cfg)
    diff = (got.int() - plain.int())[allkp.valid].abs()
    assert int(diff.max()) <= 1
    assert int((diff != 0).sum()) <= diff.numel() // 1000


def test_invalid_lanes_read_zero(main_path):
    """Invalid lanes get zero bytes from the kernel (the output is not
    zero-filled first); invalidating every other valid lane changes no
    remaining lane."""
    cfg, gsp, allkp = main_path
    got = De.compute_descriptors_all(gsp, allkp, cfg)
    assert int(got[~allkp.valid].int().abs().sum()) == 0
    keep = allkp.valid.clone()
    keep.view(-1)[keep.view(-1).nonzero()[::2, 0]] = False
    fewer = De.compute_descriptors_all(gsp, dataclasses.replace(allkp, valid=keep), cfg)
    assert int(fewer[~keep].int().abs().sum()) == 0
    assert torch.equal(fewer[keep], got[keep])


def test_wrapper_raises_on_what_the_kernel_does_not_take(main_path):
    cfg, gsp, allkp = main_path
    rmax = De.desc_radius_bound(cfg)
    bad = [
        dataclasses.replace(allkp, x=allkp.x.t().contiguous().t()) if allkp.x.shape[0] > 1
        else dataclasses.replace(allkp, x=allkp.x.double()),
        dataclasses.replace(allkp, octave=allkp.octave.long()),
        dataclasses.replace(allkp, valid=allkp.valid.cpu()),
    ]
    for kp in bad:
        with pytest.raises(ValueError):
            D.describe_kernel(gsp, kp, cfg, rmax)
    with pytest.raises(ValueError):
        D.describe_kernel(gsp, allkp, cfg, D.MAX_RMAX + 1)


@pytest.fixture(scope="module")
def pair(dev):
    """The CAVE 00 / 01 pair at the smoke capacities, on the card."""
    cfg = SiftConfig(extrema_cap=6144, kp_cap=1536, ori_cap=2048)
    frames = [np.load(DATA / f"oracle_cave0{i}.npz")["input"] for i in (0, 1)]
    imgs = S.as_batch(np.stack(frames), cfg, dev)
    return cfg, frames, imgs, S.run_route(imgs, cfg, "front_twin")[0]


@pytest.mark.parametrize("route", ["front", "twin_rows", "stacks", "staged"])
def test_every_card_route_gives_the_main_path_bytes(pair, route):
    """Every float32 route on the card reads its own gather space (kernel
    A's stacks, kernel E's strips, plain stacks, kernel H's row-major rows
    of one octave) and gives the front-twin route's keypoints and
    descriptor bytes.  Tolerance: none."""
    cfg, frames, imgs, ref = pair
    if route == "staged":
        for i, frame in enumerate(frames):
            fin = detect_stages(frame, cfg, octaves_for(imgs, cfg), device=imgs.device)["final"]
            for f in ("x", "y", "size", "pori", "octave", "layer", "desc"):
                assert torch.equal(getattr(fin, f)[fin.valid], getattr(ref, f)[i][ref.valid[i]]), f
        return
    got = S.run_route(imgs, cfg, route)[0]
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
