"""Kernel K's order of sums and its launch, on the CPU (``ops/orient.py``).

Kernel K (``csrc/describe.cu``, beside kernel I) computes the orientation
stage in one launch on the card: each histogram bin sums its contributions
in row-major order of the lane's own window samples, then the reference's
smoothing, peaks and slots follow as the plain chain computes them.
``orient_ordered_plain`` is that order in plain PyTorch, on the samples the
plain chain computes from patches read through each space's own ``index``;
the card's tests (``test_torch_orient_kernel.py``) hold the kernel to it bit
for bit.  Here it is held to the plain chain the CPU runs (``orient_plain``)
in float32 and float64, to itself over windows and layouts, the launch's
structs to the ``.cu``'s, the wrapper's rejections to what the kernel takes,
and the dispatch to its rule: the CPU and float64 keep the plain chain.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from sift_tpu_torch import SiftConfig
from sift_tpu_torch.config import ORI_SMOOTH_ITERATIONS
from sift_tpu_torch.models import orient as O
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.ops import describe as D
from sift_tpu_torch.ops import orient as OK
from sift_tpu_torch.ops.gather import StackSpace, build_block_rows, build_multi_rows
from sift_tpu_torch.ops.twin_rows import twin_rows_strips
from sift_tpu_torch.utils import keypoints as K

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
CU = ROOT / "sift_tpu_torch" / "csrc" / "describe.cu"
CAPS = dict(extrema_cap=6144, kp_cap=1536, ori_cap=2048)
FIELDS = ("valid", "x", "y", "size", "octave", "layer")


def _oracle(name):
    return dict(np.load(DATA / f"oracle_{name}.npz"))


def _refined(img, cfg):
    """An image and its flip through the stacks route's stages 1-2 on the
    CPU: (the batch, its gauss stacks, refined keypoints (2, kp_cap))."""
    imgs = S.as_batch(np.stack([img, img[::-1]]), cfg, "cpu")
    gaussians, dogs = S.pyramids(imgs, cfg)
    return imgs, gaussians, S._detect_refine_fused(dogs, cfg, False)[0]


@pytest.fixture(scope="module")
def crop_run():
    """A 240 x 320 crop of CAVE 00 and its flip, float32 on the CPU: the
    config, the pyramid's gauss stacks, the refined keypoints and the gauss
    space of each layout orient reads (the stacks route's ``StackSpace``,
    kernel E's strip-interleaved and the front-twin route's layer-minor
    ``MultiRows``, and the row-major rows of image 0)."""
    cfg = SiftConfig(**CAPS)
    imgs, gaussians, kp = _refined(_oracle("cave00")["input"][120:360, 160:480], cfg)
    gsp, *front = S.front_twin(imgs, cfg)
    spaces = dict(stack=StackSpace.build(gaussians),
                  strips=twin_rows_strips(gaussians, S.TWIN_BLK), layer_minor=gsp,
                  rows=build_multi_rows([g[0] for g in gaussians]))
    spaces["front_twin_kp"] = S.detect_refine(*front, cfg)[0]
    return cfg, gaussians, kp, spaces


def _cu_struct(name):
    """(name, C type, array length) of every field of struct ``name`` in
    ``csrc/describe.cu``, in order."""
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", CU.read_text(), re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = re.match(r"(long long|int|float)\s+(.*)", decl, re.S).groups()
        for nm in names.split(","):
            m = re.match(r"\s*(\w+)(?:\[(\w+)\])?\s*$", nm)
            fields.append((m.group(1), ctype, m.group(2)))
    return fields


@pytest.mark.parametrize("name,struct", [("DescArgs", D._Args), ("OriArgs", OK._OriArgs)])
def test_args_structs_mirror_the_cu(name, struct):
    """The Python structs list the ``.cu``'s fields in its order, with its
    types and array lengths; the module's constants are the ``.cu``'s."""
    text = CU.read_text()
    consts = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", text)}
    assert (consts["MAXV"], consts["ORI_WARPS"], consts["MAXBINS"], consts["MAXSLOTS"]) == (
        D.MAXV, OK.ORI_WARPS, OK.MAXBINS, OK.MAXSLOTS)
    assert consts["SMOOTH_ITERATIONS"] == ORI_SMOOTH_ITERATIONS
    ctypes_of = {"long long": ctypes.c_longlong, "int": ctypes.c_int, "float": ctypes.c_float}
    got = []
    for fname, ct in struct._fields_:
        length = getattr(ct, "_length_", None)
        got.append((fname, ct._type_ if length else ct, length))
    want = [(n, ctypes_of[t], consts[k] if k else None) for n, t, k in _cu_struct(name)]
    assert got == want


def test_max_rmax_fits_the_shared_memory():
    """ORI_WARPS lanes' patches and gaussian factors, beside the static
    arrays (a histogram and the slots' orientations a lane), fit the 227 KB
    a block may use at MAX_RMAX, and not one radius more."""

    def smem(r):
        return (OK.ORI_WARPS * ((2 * r + 3) ** 2 + 2 * r + 1) * 4
                + OK.ORI_WARPS * (OK.MAXBINS + OK.MAXSLOTS) * 4)

    assert smem(OK.MAX_RMAX) <= 232_448 < smem(OK.MAX_RMAX + 1)
    assert O.ori_radius_bound(SiftConfig()) <= OK.MAX_RMAX


def test_launch_arguments_carry_the_layout_and_the_constants(crop_run):
    """The structs the launch passes: kernel I's with the layer-minor
    layout, orient's radius bound and I's tables, whose scale times
    ``halve`` is exactly the plain chain's 1 / 2^octave; orient's own with
    the configuration's counts and its constants as PyTorch rounds them
    (the plain chain's Python numbers, cast to float32)."""
    cfg, _, _, spaces = crop_run
    sp = spaces["layer_minor"]
    nv = len(sp.shapes)
    tables = D.octave_tables(sp, cfg)
    rmax = O.ori_radius_bound(cfg)
    a = D._args(D.layout_of(sp), tables, cfg, cfg.kp_cap, 2 * cfg.kp_cap, rmax)
    g = OK._ori_args(cfg)
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    assert (a.mode, a.nvol, a.rmax, a.n, a.lanes, a.o0) == (
        D.MODE_LAYER_MINOR, nv, 17, cfg.kp_cap, 2 * cfg.kp_cap, 0)
    assert [f32(p * g.halve) for p in a.pow_denom[:nv]] == [f32(1 / 2 ** o) for o in range(nv)]
    assert (g.nbins, g.slots, g.halve) == (36, 8, 0.5)
    assert (g.sigma, g.ratio, g.pi, a.pi2) == (f32(1.5), f32(0.8), f32(math.pi),
                                               f32(6.283185307179586))
    assert OK._ori_args(dataclasses.replace(cfg, double_image_size=False)).halve == 1.0


@pytest.fixture(scope="module", params=["crop", "small"])
def plain_vs_ordered(request, crop_run):
    if request.param == "crop":
        cfg, _, kp, spaces = crop_run
        sp = spaces["stack"]
    else:  # oracle_small and its flip
        cfg = SiftConfig(**CAPS)
        _, gaussians, kp = _refined(_oracle("small")["input"], cfg)
        sp = StackSpace.build(gaussians)
    plain = O.orient_plain(sp, kp, cfg)
    ordered = OK.orient_ordered_plain(sp, kp, cfg, O.ori_radius_classes(cfg))
    return cfg, sp, kp, plain, ordered


def test_ordered_model_is_the_plain_chain_up_to_the_order_of_sums(plain_vs_ordered):
    """Against the plain chain the CPU runs (one-hot ``bmm`` per radius
    class) in float32: the same candidates (validity, x, y, size, octave,
    layer) and max_peaks, pori within 1e-5 rad on valid candidates; only
    the order of the histogram's float32 sums differs.  Measured: pori off
    on 5 of the crop's valid candidates, by at most 1.9e-6 rad."""
    _, _, _, (a, pa), (b, pb) = plain_vs_ordered
    assert int(pa) == int(pb)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.valid.sum()) > 0
    assert float((a.pori - b.pori)[a.valid].abs().max()) <= 1e-5
    assert int(b.pori[~b.valid].abs().sum()) == 0  # slots past a lane's peaks


def test_ordered_model_meets_the_plain_chain_in_float64():
    """In float64 the order of sums moves pori by rounding alone: the same
    candidates, pori within 1e-12 rad."""
    cfg = SiftConfig(**CAPS, dtype=torch.float64)
    _, gaussians, kp = _refined(_oracle("small")["input"], cfg)
    sp = StackSpace.build(gaussians)
    a, pa = O.orient_plain(sp, kp, cfg)
    b, pb = OK.orient_ordered_plain(sp, kp, cfg, O.ori_radius_classes(cfg))
    assert int(pa) == int(pb) and int(a.valid.sum()) > 0
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert float((a.pori - b.pori)[a.valid].abs().max()) <= 1e-12


@pytest.mark.parametrize("name", ["layer_minor", "strips", "rows", "staged"])
def test_every_layout_gives_the_same_ordered_candidates(crop_run, name):
    """The order model over each layout gives the stack space's candidates
    bit for bit: the layouts hold the same values and the order depends on
    the lane alone.  ``staged``: each octave's one-volume row-major rows
    (the staged path's space), on image 0's slots of that octave."""
    cfg, gaussians, kp, spaces = crop_run
    radii = O.ori_radius_classes(cfg)
    want, pw = OK.orient_ordered_plain(spaces["stack"], kp, cfg, radii)
    if name in ("layer_minor", "strips"):
        got, pg = OK.orient_ordered_plain(spaces[name], kp, cfg, radii)
        assert int(pg) == int(pw)
        for f in K.FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        return
    kp0 = kp.map(lambda a: a[:1])
    want0 = want.map(lambda a: a[:1])
    if name == "rows":
        got, _ = OK.orient_ordered_plain(spaces["rows"], kp0, cfg, radii)
        for f in K.FIELDS:
            assert torch.equal(getattr(got, f), getattr(want0, f)), f
        return
    slot_oct = want0.octave
    seen = 0
    for o, g in enumerate(gaussians):
        got, _ = OK.orient_ordered_plain(build_multi_rows([g[0]]), kp0, cfg, radii,
                                         octave_of_volume=(o,))
        sel = slot_oct == o
        seen += int((sel & want0.valid).sum())
        for f in K.FIELDS:
            assert torch.equal(getattr(got, f)[sel], getattr(want0, f)[sel]), (o, f)
    assert seen == int(want0.valid.sum()) > 0


def test_ordered_candidates_do_not_depend_on_the_window(crop_run):
    """A lane gives the same bits in the window of its own class, of class
    13 and of 17: a wider window adds exact zeros only (masked samples),
    and the row-major order keeps the non-zero terms in the same order."""
    cfg, _, kp, spaces = crop_run
    sp = spaces["stack"]
    radius = O._lane_args(sp, kp, cfg, None)[1][O._RADIUS]
    assert int((radius <= 11).sum()) > 0 and int((radius > 13).sum()) > 0
    by_class, _ = OK.orient_ordered_plain(sp, kp, cfg, O.ori_radius_classes(cfg))
    for radii in ([13, 17], [17]):
        got, _ = OK.orient_ordered_plain(sp, kp, cfg, radii)
        for f in K.FIELDS:
            assert torch.equal(getattr(got, f), getattr(by_class, f)), (radii, f)


def test_invalid_lanes_give_invalid_candidates(crop_run):
    """An invalid lane's slots carry its fields (x, y, size halved), pori 0
    and no validity; invalidating every other valid lane changes no
    remaining lane's slots; no valid lane at all gives max_peaks 0."""
    cfg, _, kp, spaces = crop_run
    sp = spaces["stack"]
    radii = O.ori_radius_classes(cfg)
    slots = cfg.ori_cand_slots
    keep = kp.valid.clone()
    keep.view(-1)[keep.view(-1).nonzero()[::2, 0]] = False
    fewer, _ = OK.orient_ordered_plain(sp, dataclasses.replace(kp, valid=keep), cfg, radii)
    full, _ = OK.orient_ordered_plain(sp, kp, cfg, radii)
    rep = keep.repeat_interleave(slots, dim=-1)
    assert not bool(fewer.valid[~rep].any()) and int(fewer.pori[~rep].abs().sum()) == 0
    assert torch.equal(fewer.x, (kp.x * 0.5).repeat_interleave(slots, dim=-1))
    for f in K.FIELDS:
        assert torch.equal(getattr(fewer, f)[rep], getattr(full, f)[rep]), f
    none, peaks = OK.orient_ordered_plain(
        sp, dataclasses.replace(kp, valid=torch.zeros_like(kp.valid)), cfg, radii)
    assert int(peaks) == 0 and not bool(none.valid.any())


def _kp_like(kp, **repl):
    return dataclasses.replace(kp, **repl)


@pytest.mark.parametrize("fault", ["x_float64", "octave_int64", "valid_uint8", "size_shape",
                                   "layer_strided", "space_float64", "rmax", "bins", "slots",
                                   "block_rows", "cpu"])
def test_orient_kernel_rejects(fault):
    """The wrapper raises on what the kernel does not take, before its
    device check: a field of another type, shape or stride, a gather space
    of another type or layout, an rmax past shared memory, more bins or
    slots than a warp holds; tensors off the card last."""
    cfg = SiftConfig(**CAPS)
    b, n = 2, 8
    f32 = torch.zeros((b, n), dtype=torch.float32)
    kp = K.Keypoints(x=f32, y=f32.clone(), octave=torch.zeros((b, n), dtype=torch.int32),
                     layer=torch.ones((b, n), dtype=torch.int32), size=f32.clone(),
                     pori=f32.clone(), desc=torch.zeros((b, n, 128), dtype=torch.uint8),
                     valid=torch.zeros((b, n), dtype=torch.bool))
    sp = StackSpace.build([torch.zeros((b, 6, 16, 24)), torch.zeros((b, 6, 8, 12))])
    rmax = 17
    if fault == "x_float64":
        kp = _kp_like(kp, x=kp.x.double())
    elif fault == "octave_int64":
        kp = _kp_like(kp, octave=kp.octave.long())
    elif fault == "valid_uint8":
        kp = _kp_like(kp, valid=kp.valid.to(torch.uint8))
    elif fault == "size_shape":
        kp = _kp_like(kp, size=torch.zeros((b, n + 1)))
    elif fault == "layer_strided":
        kp = _kp_like(kp, layer=torch.zeros((n, b), dtype=torch.int32).t())
    elif fault == "space_float64":
        sp = StackSpace.build([torch.zeros((b, 6, 16, 24), dtype=torch.float64)])
    elif fault == "rmax":
        rmax = OK.MAX_RMAX + 1
    elif fault == "bins":
        cfg = dataclasses.replace(cfg, num_bins=OK.MAXBINS + 1)
    elif fault == "slots":
        cfg = dataclasses.replace(cfg, ori_cand_slots=OK.MAXSLOTS + 1)
    elif fault == "block_rows":
        sp = build_block_rows(torch.zeros((6, 16, 24)))
    match = "one card" if fault == "cpu" else None
    with pytest.raises(TypeError if fault == "block_rows" else ValueError, match=match):
        OK.orient_kernel(sp, kp, cfg, rmax)


@pytest.mark.parametrize("name", ["layer_minor", "rows"])
def test_route_keypoints_pass_every_check_but_the_card(crop_run, name):
    """The keypoints the routes hand to orientation, made contiguous as
    ``orient_all`` makes them, pass every check of the wrapper on the CPU
    but the device's: the front-twin route's buffer and the staged path's
    one-octave lanes."""
    cfg, gaussians, kp, spaces = crop_run
    if name == "rows":
        st = S.detect_stages(_oracle("cave00")["input"][120:360, 160:480], cfg, len(gaussians),
                             device="cpu")
        kp, sp, oov = st["refined"][1].map(lambda a: a[None]), build_multi_rows(
            [st["gaussians"][1]]), (1,)
    else:
        kp, sp, oov = spaces["front_twin_kp"], spaces[name], None
    assert int(kp.valid.sum()) > 0
    with pytest.raises(ValueError, match="one card"):
        OK.orient_kernel(sp, kp.map(lambda a: a.contiguous()), cfg, O.ori_radius_bound(cfg),
                         oov)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_cpu_and_float64_keep_the_plain_chain(monkeypatch, crop_run, dtype):
    """``orient_all`` on the CPU, in float32 and float64, returns
    ``orient_plain``'s candidates bit for bit and never reaches the kernel's
    wrapper; float64 on the card would not either (the rule reads the
    dtype and the device alone)."""
    cfg, _, kp, spaces = crop_run
    if dtype == torch.float64:
        cfg = SiftConfig(**CAPS, dtype=dtype)
        _, gaussians, kp = _refined(_oracle("small")["input"], cfg)
        sp = StackSpace.build(gaussians)
    else:
        sp = spaces["stack"]

    def no_kernel(*a, **k):
        raise AssertionError("the plain chain's inputs reached kernel K")

    want, pw = O.orient_plain(sp, kp, cfg)
    monkeypatch.setattr(O, "orient_kernel", no_kernel)
    got, pg = O.orient_all(sp, kp, cfg)
    assert int(pg) == int(pw) and int(got.valid.sum()) > 0
    for f in K.FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.desc.shape == (*got.valid.shape, 128) and int(got.desc.sum()) == 0
