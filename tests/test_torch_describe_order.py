"""Kernel I's order of sums, on the CPU (``ops/describe.py``).

Kernel I (``csrc/describe.cu``) computes the descriptor stage in one launch
on the card: each histogram bin sums its contributions in row-major order
of the lane's own window samples, each sum of squares is a fixed tree over
the 128 bins.  ``describe_ordered_plain`` is that order in plain PyTorch,
on the patches the plain chain reads through each space's own ``index``;
the card's tests (``test_torch_describe_kernel.py``) hold the kernel to it
bit for bit.  Here it is held to the plain chain the CPU runs
(``compute_descriptors_plain``), to the C++ oracle's bytes and to itself
over windows and layouts, and the launch's layout to each space's fields.
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
from sift_tpu_torch.ops import describe as D
from sift_tpu_torch.ops.gather import StackSpace, build_block_rows, build_multi_rows
from sift_tpu_torch.ops.twin_rows import twin_rows_strips
from sift_tpu_torch.utils import keypoints as K
from sift_tpu_torch.utils.keypoints import FIELDS

torch.set_num_threads(2)
DATA = pathlib.Path(__file__).parent / "data"
CAPS = dict(extrema_cap=6144, kp_cap=1536, ori_cap=2048)


def _oracle(name):
    return dict(np.load(DATA / f"oracle_{name}.npz"))


@pytest.fixture(scope="module")
def crop_run():
    """A 240 x 320 crop of CAVE 00 and its flip, float32 on the CPU: the
    config, the pyramid's gauss stacks, the post-dedup keypoints and the
    gauss space of each layout describe reads (the stacks route's
    ``StackSpace``, kernel E's strip-interleaved and the front-twin route's
    layer-minor ``MultiRows``, and the staged path's row-major rows of
    image 0)."""
    crop = _oracle("cave00")["input"][120:360, 160:480]
    cfg = SiftConfig(**CAPS)
    imgs = S.as_batch(np.stack([crop, crop[::-1]]), cfg, "cpu")
    gaussians, dogs = S.pyramids(imgs, cfg)
    kp, _ = S._detect_refine_fused(dogs, cfg, False)
    stack = StackSpace.build(gaussians)
    allkp = S.dedup(S.orient(stack, kp, cfg)[0], cfg)
    spaces = dict(stack=stack, strips=twin_rows_strips(gaussians, S.TWIN_BLK),
                  layer_minor=S.front_twin(imgs, cfg)[0],
                  rows=build_multi_rows([g[0] for g in gaussians]))
    return cfg, allkp, spaces


@pytest.mark.parametrize("name", ["stack", "strips", "layer_minor", "rows"])
def test_layout_of_reads_each_space(crop_run, name):
    """The numbers the launch passes for each layout: its index mode and,
    per volume, the space's own bases, shapes, blocks, strip shifts and
    stored layers (zero where the layout has none)."""
    _, _, spaces = crop_run
    sp = spaces[name]
    lay = D.layout_of(sp)
    nv = len(sp.shapes)
    zeros = (0,) * nv
    assert lay.mode == dict(stack=D.MODE_STACK, rows=D.MODE_ROWS, strips=D.MODE_STRIPS,
                            layer_minor=D.MODE_LAYER_MINOR)[name]
    assert lay.base == tuple(int(b) for b in sp.bases)
    assert (lay.H, lay.W) == (tuple(s[1] for s in sp.shapes), tuple(s[2] for s in sp.shapes))
    assert lay.s_max == sp.shapes[0][0] - 1
    if name == "stack":
        assert (lay.rt, lay.blk, lay.l0, lay.nb, lay.ls, lay.nl) == (sp.total, 0, 0, zeros,
                                                                     zeros, zeros)
        return
    assert (lay.rt, lay.blk, lay.l0, lay.nb) == (sp.rows.shape[-2], sp.blk, sp.l0,
                                                 tuple(sp.nbs))
    assert lay.ls == (zeros if name == "rows" else tuple(sp.shp))
    assert lay.nl == (tuple(sp.nls) if name == "layer_minor" else zeros)


@pytest.mark.parametrize("name", ["layer_minor", "strips", "rows"])
def test_every_layout_gives_the_same_ordered_bytes(crop_run, name):
    """The order model over each layout gives the stack space's bytes:
    the layouts hold the same values and the order depends on the lane
    alone.  Tolerance: none."""
    cfg, allkp, spaces = crop_run
    radii = De.desc_radius_classes(cfg)
    want = D.describe_ordered_plain(spaces["stack"], allkp, cfg, radii)
    if name == "rows":  # one image: image 0's lanes
        kp0 = allkp.map(lambda a: a[:1])
        assert torch.equal(D.describe_ordered_plain(spaces[name], kp0, cfg, radii), want[:1])
        return
    assert torch.equal(D.describe_ordered_plain(spaces[name], allkp, cfg, radii), want)


def test_ordered_bytes_do_not_depend_on_the_window(crop_run):
    """A lane gives the same bits in the window of its own class, of class
    20 and of 40: a wider window adds exact zeros only (masked samples), and
    the row-major order keeps the non-zero terms in the same order."""
    cfg, allkp, spaces = crop_run
    sp = spaces["stack"]
    radius = De._lane_args(sp, allkp, cfg, None)[1][De._RADIUS]
    assert int((radius <= 20).sum()) > 0 and int((radius > 20).sum()) > 0
    by_class = D.describe_ordered_plain(sp, allkp, cfg, De.desc_radius_classes(cfg))
    for radii in ([20, 40], [40]):
        assert torch.equal(D.describe_ordered_plain(sp, allkp, cfg, radii), by_class), radii


@pytest.fixture(scope="module", params=["crop", "small"])
def plain_vs_ordered(request, crop_run):
    if request.param == "crop":
        cfg, allkp, spaces = crop_run
        sp = spaces["stack"]
    else:  # oracle_small and its mirror image
        img = _oracle("small")["input"]
        cfg = SiftConfig(**CAPS)
        gaussians, dogs = S.pyramids(S.as_batch(np.stack([img, img[:, ::-1]]), cfg, "cpu"), cfg)
        kp, _ = S._detect_refine_fused(dogs, cfg, False)
        sp = StackSpace.build(gaussians)
        allkp = S.dedup(S.orient(sp, kp, cfg)[0], cfg)
    plain = De.compute_descriptors_plain(sp, allkp, cfg)
    ordered = D.describe_ordered_plain(sp, allkp, cfg, De.desc_radius_classes(cfg))
    return cfg, sp, allkp, plain, ordered


def test_ordered_model_is_the_plain_chain_up_to_the_order_of_sums(plain_vs_ordered):
    """Against the plain chain the CPU runs (``bmm`` over radius classes,
    ``sum`` for the norms): at most 0.1% of the valid lanes' bytes off,
    each by at most 1.  Only the order of float32 sums differs, so a byte
    moves only where 512 v lies within a few ulps of an integer.  Measured
    here: no byte off on either input (23,552 bytes of the crop's 184
    lanes, and the small image's)."""
    _, _, allkp, plain, ordered = plain_vs_ordered
    assert int(allkp.valid.sum()) > 0
    diff = (plain.int() - ordered.int())[allkp.valid].abs()
    assert int(diff.max()) <= 1
    assert int((diff != 0).sum()) <= diff.numel() // 1000


def test_ordered_model_zeroes_invalid_lanes(plain_vs_ordered):
    """Invalid lanes read zero bytes; dropping every other valid lane
    changes no remaining lane's bytes."""
    cfg, sp, allkp, _, ordered = plain_vs_ordered
    assert int(ordered[~allkp.valid].abs().sum()) == 0
    keep = allkp.valid.clone()
    keep.view(-1)[keep.view(-1).nonzero()[::2, 0]] = False
    fewer = D.describe_ordered_plain(sp, dataclasses.replace(allkp, valid=keep), cfg,
                                     De.desc_radius_classes(cfg))
    assert int(fewer[~keep].abs().sum()) == 0
    assert torch.equal(fewer[keep], ordered[keep])


@pytest.mark.parametrize("name", ["cave00", "demo1", "small"])
def test_ordered_model_meets_the_oracle_as_the_plain_chain_does(name):
    """On the C++ oracle's final keypoints of its own input, over the port's
    float32 pyramid: the order model is as close to the oracle's descriptor
    bytes as the plain chain (no more bytes off, none off by more).
    Measured: 0.0023% / 0.0006% / 0% of bytes off by 1 for both."""
    o = _oracle(name)
    cfg = SiftConfig(**CAPS)
    n = len(o["final.x"])
    kp = K.Keypoints.from_numpy({**{f: o[f"final.{f}"] for f in FIELDS if f != "valid"},
                                 "valid": np.ones(n, bool)})
    kp = kp.map(lambda a: (a.float() if a.is_floating_point() else a)[None])
    gaussians, _ = S.pyramids(S.as_batch(o["input"][None], cfg, "cpu"), cfg)
    sp = StackSpace.build(gaussians)
    want = torch.from_numpy(o["final.desc"].astype(np.int32))
    plain = (De.compute_descriptors_plain(sp, kp, cfg)[0].int() - want).abs()
    ordered = (D.describe_ordered_plain(sp, kp, cfg, De.desc_radius_classes(cfg))[0].int()
               - want).abs()
    assert int((ordered != 0).sum()) <= int((plain != 0).sum())
    assert int(ordered.max()) <= max(int(plain.max()), 1)


def _kp_like(kp, **repl):
    return dataclasses.replace(kp, **repl)


@pytest.mark.parametrize("fault", ["x_float64", "octave_int64", "valid_uint8", "size_shape",
                                   "pori_strided", "space_float64", "rmax", "block_rows",
                                   "cpu"])
def test_describe_kernel_rejects(fault):
    """The wrapper raises on what the kernel does not take: a field of
    another type, shape or stride, a gather space of another type or
    layout, an rmax past shared memory, tensors off the card."""
    cfg = SiftConfig(**CAPS)
    b, n = 2, 8
    f32 = torch.zeros((b, n), dtype=torch.float32)
    kp = K.Keypoints(x=f32, y=f32.clone(), octave=torch.zeros((b, n), dtype=torch.int32),
                     layer=torch.ones((b, n), dtype=torch.int32), size=f32.clone(),
                     pori=f32.clone(), desc=torch.zeros((b, n, 128), dtype=torch.uint8),
                     valid=torch.zeros((b, n), dtype=torch.bool))
    sp = StackSpace.build([torch.zeros((b, 6, 16, 24)), torch.zeros((b, 6, 8, 12))])
    rmax = 40
    if fault == "x_float64":
        kp = _kp_like(kp, x=kp.x.double())
    elif fault == "octave_int64":
        kp = _kp_like(kp, octave=kp.octave.long())
    elif fault == "valid_uint8":
        kp = _kp_like(kp, valid=kp.valid.to(torch.uint8))
    elif fault == "size_shape":
        kp = _kp_like(kp, size=torch.zeros((b, n + 1)))
    elif fault == "pori_strided":
        kp = _kp_like(kp, pori=torch.zeros((n, b)).t())
    elif fault == "space_float64":
        sp = StackSpace.build([torch.zeros((b, 6, 16, 24), dtype=torch.float64)])
    elif fault == "rmax":
        rmax = D.MAX_RMAX + 1
    elif fault == "block_rows":
        sp = build_block_rows(torch.zeros((6, 16, 24)))
    with pytest.raises(TypeError if fault == "block_rows" else ValueError):
        D.describe_kernel(sp, kp, cfg, rmax)


def test_launch_arguments_carry_the_layout_and_the_tables(crop_run):
    """The struct the launch passes holds the layer-minor layout, the
    per-octave tables as float32 and the constants as PyTorch rounds them
    (the plain chain's Python numbers, cast to float32)."""
    cfg, _, spaces = crop_run
    sp = spaces["layer_minor"]
    lay = D.layout_of(sp)
    tables = D.octave_tables(sp, cfg)
    a = D._args(lay, tables, cfg, 2048, 4096, 40)
    nv = len(sp.shapes)
    assert (a.mode, a.nvol, a.blk, a.l0, a.rt) == (D.MODE_LAYER_MINOR, nv, sp.blk, sp.l0,
                                                   sp.rows.shape[-2])
    assert list(a.base[:nv]) == list(sp.bases) and list(a.nl[:nv]) == list(sp.nls)
    assert list(a.ls[:nv]) == list(sp.shp) and list(a.nb[:nv]) == list(sp.nbs)
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    assert list(a.pow_denom[:nv]) == [f32(v) for v in tables[1]]
    assert list(a.diag[:nv]) == [f32(v) for v in tables[2]]
    assert (a.pi2, a.obin, a.thr, a.sqrt2) == (f32(6.283185307179586), f32(8 / 6.283185307179586),
                                               f32(0.2), f32(2 ** 0.5))
    assert (a.n, a.lanes, a.rmax, a.o0, a.s_max) == (2048, 4096, 40, 0, sp.shapes[0][0] - 1)
