"""Kernel J's launch, on the CPU (``ops/detect.py``).

Kernel J (``csrc/detect.cu``) computes stage 2 of the front routes in one
launch on the card, bit for bit what the plain chain of ``models/detect.py``
returns (the card's tests, ``test_torch_detect_kernel.py``, hold it there).
Here: the argument struct against the ``.cu``'s and against each DoG gather
space's fields at the benchmark cells' shapes, the kernel's index rule
(``space_index``) against ``CubeRows.index`` and ``StackSpace.index``, the
wrapper's rejections before any device check, and the dispatch: the CPU and
float64 keep the plain chain, the non-front routes never reach the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from sift_tpu_torch import SiftConfig
from sift_tpu_torch.models import detect as Dt
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.models.pyramid import blur_half_kernels
from sift_tpu_torch.ops import detect as DJ
from sift_tpu_torch.ops.gather import CubeRows, StackSpace, cube_rows_params, gather_cubes
from sift_tpu_torch.utils.keypoints import FIELDS

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
CU = ROOT / "sift_tpu_torch" / "csrc" / "detect.cu"
CAPS = dict(extrema_cap=1024, kp_cap=256, ori_cap=512)
# The benchmark's cells: (batch, frame height, width, capacities).
CELLS = dict(
    resident_b16=(16, 480, 640, dict(extrema_cap=12288, kp_cap=2048, ori_cap=3072)),
    cli_pair=(2, 499, 755, {}),
    panorama=(1, 480, 640, dict(extrema_cap=12288, kp_cap=2048, ori_cap=3072)),
)


def crop_batch(dtype=torch.float32):
    crop = np.load(DATA / "oracle_cave00.npz")["input"][120:240, 160:320]
    cfg = SiftConfig(**CAPS, dtype=dtype, use_octave_kernel=True)
    return cfg, S.as_batch(np.stack([crop, crop[::-1]]), cfg, "cpu")


@pytest.fixture(scope="module")
def crop_spaces():
    """A crop of CAVE 00 and its flip on the CPU: the front-twin route's DoG
    ``CubeRows`` and the front route's ``StackSpace``, each with its masks
    and popcounts."""
    cfg, imgs = crop_batch()
    _, dsp, masks, counts = S.front_twin(imgs, cfg)
    _, dogs, fmasks, fcounts = S.front(imgs, cfg)
    return cfg, dict(cube_rows=(dsp, masks, counts),
                     stack=(StackSpace.build(dogs), fmasks, fcounts))


def cube_rows_at(cfg, bsz, h, w):
    """The front-twin route's DoG ``CubeRows`` for (h, w) frames, built from
    the plan as ``front_twin_pyramids`` builds it, over a buffer of the
    right shape that holds no memory."""
    h1, w1 = 2 * h, 2 * w
    plan = S.front_twin_plan(cfg, cfg.octaves_count(w1, h1), h1, w1)
    n = len(blur_half_kernels(cfg))
    stride, sw, _ = cube_rows_params(n, plan.octaves[0][1])
    return CubeRows(rows=torch.zeros(()).expand(bsz, plan.pk_total, 128),
                    shapes=tuple((n, o[0], o[1]) for o in plan.octaves), nbps=plan.pk_nbps,
                    bases=plan.pk_bases, stride=stride, sw=sw,
                    lss=tuple(o[2].bit_length() - 1 for o in plan.octaves))


def masks_for(sp, bsz):
    """Stand-ins of the octave fronts' masks and popcounts for a space's
    octaves: the right shapes, no memory (not contiguous: for
    ``make_args``, which reads shapes and addresses only)."""
    n_int = sp.shapes[0][0] - 2
    masks, counts = [], []
    for _, h, w in sp.shapes:
        nbm = -(-w // 128)
        masks.append(torch.zeros(()).expand(bsz, n_int, h, nbm * 128))
        counts.append(torch.zeros((), dtype=torch.int32).expand(bsz, n_int, h, nbm))
    return masks, counts


def test_cube_rows_at_is_the_routes_space(crop_spaces):
    cfg, spaces = crop_spaces
    dsp = spaces["cube_rows"][0]
    got = cube_rows_at(cfg, 2, 120, 160)
    assert got.rows.shape == dsp.rows.shape
    for f in ("shapes", "nbps", "bases", "stride", "sw", "lss"):
        assert getattr(got, f) == getattr(dsp, f), f


def _cu_struct():
    """(name, C type, array length) of every field of ``DetectArgs`` in
    ``csrc/detect.cu``, in order."""
    body = re.search(r"struct DetectArgs \{(.*?)\n\};", CU.read_text(), re.S).group(1)
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


def test_args_struct_mirrors_the_cu():
    """``_Args`` lists ``DetectArgs``' fields in its order, with its types
    and array lengths; the module's constants are the ``.cu``'s."""
    text = CU.read_text()
    consts = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", text)}
    assert (consts["MAXV"], consts["MAXP"]) == (DJ.MAXV, DJ.MAXP)
    assert "MODE_STACK = 0, MODE_CUBE_ROWS = 1" in text
    assert (DJ.MODE_STACK, DJ.MODE_CUBE_ROWS) == (0, 1)
    ctypes_of = {"long long": ctypes.c_longlong, "int": ctypes.c_int, "float": ctypes.c_float}
    got = []
    for name, ct in DJ._Args._fields_:
        length = getattr(ct, "_length_", None)
        got.append((name, ct._type_ if length else ct, length))
    want = [(n, ctypes_of[t], consts[k] if k else None) for n, t, k in _cu_struct()]
    assert got == want


def test_max_lanes_fits_the_shared_memory():
    """Two bits a lane of dynamic shared memory, beside the static arrays
    (about 600 bytes), stay under the 227 KB a block may use."""
    assert 2 * (DJ.MAX_LANES // 32) * 4 + 1024 <= 227 * 1024


@pytest.mark.parametrize("cell", list(CELLS))
def test_args_read_each_cells_cube_rows(cell):
    """The launch's numbers at a benchmark cell's shapes: the space's
    packed-row layout per octave, the masks' blocks, the octave scales, the
    capacities and cascade schedule, and the chain's constants as float32."""
    bsz, h, w, caps = CELLS[cell]
    cfg = SiftConfig(**caps)
    sp = cube_rows_at(cfg, bsz, h, w)
    masks, counts = masks_for(sp, bsz)
    lay = DJ.layout_of(sp)
    phases = Dt.refine_cascade_caps(cfg, cfg.extrema_cap)
    a = DJ.make_args(lay, masks, counts, cfg, phases)
    nv = len(sp.shapes)
    assert (a.mode, a.nvol, a.rt, a.stride, a.sw, a.width) == (
        DJ.MODE_CUBE_ROWS, nv, sp.rows.shape[-2], sp.stride, sp.sw, 128)
    assert list(a.base[:nv]) == list(sp.bases) and list(a.nbp[:nv]) == list(sp.nbps)
    assert list(a.ls[:nv]) == list(sp.lss)
    for i, f in enumerate(("S", "H", "W")):
        assert list(getattr(a, f)[:nv]) == [s[i] for s in sp.shapes]
    assert list(a.nbm[:nv]) == [-(-s[2] // 128) for s in sp.shapes]
    assert list(a.scale[:nv]) == [2.0 ** o for o in range(nv)]
    assert list(a.counts[:nv]) == [c.data_ptr() for c in counts]
    assert list(a.masks[:nv]) == [m.data_ptr() for m in masks]
    assert all(list(getattr(a, f)[nv:]) == [0] * (DJ.MAXV - nv)
               for f in ("base", "S", "H", "W", "nbp", "ls", "nbm", "counts", "masks"))
    assert (a.n_int, a.n, a.kp_cap, a.depth, a.border) == (
        sp.shapes[0][0] - 2, cfg.extrema_cap, cfg.kp_cap, sp.shapes[0][0], 1)
    assert a.nph == len(phases) == 2
    assert [(a.cap[i], a.steps[i]) for i in range(a.nph)] == list(phases)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    assert (a.c255, a.intervals, a.init_sigma, a.contrast, a.eigen_ratio, a.edge_lim) == (
        255.0, 3.0, f32(cfg.init_sigma), f32(cfg.contrast_threshold), f32(cfg.eigen_ratio),
        f32((cfg.eigen_ratio + 1) * (cfg.eigen_ratio + 1)))


def test_args_read_the_stack_space(crop_spaces):
    cfg, spaces = crop_spaces
    sp, masks, counts = spaces["stack"]
    lay, bsz = DJ._check(sp, masks, counts, cfg)
    a = DJ.make_args(lay, masks, counts, dataclasses.replace(cfg, refine_active_cap=100),
                     ((100, 4),))
    nv = len(sp.shapes)
    assert (a.mode, a.rt, a.stride, a.sw, a.width) == (DJ.MODE_STACK, sp.total, 0, 0, 0)
    assert bsz == 2 and list(a.base[:nv]) == list(sp.bases)
    assert [list(getattr(a, f)[:nv]) for f in ("S", "H", "W")] == [
        [s[i] for s in sp.shapes] for i in range(3)]
    assert (a.nph, a.cap[0], a.steps[0]) == (1, 100, 4)


def _index_cases(sp, bsz, n, seed):
    """``n`` random cube centres (img, octave, z, y, x) over every octave of
    a space, interior as gather_cubes clamps them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        o = int(rng.integers(len(sp.shapes)))
        s, h, w = sp.shapes[o]
        out.append((int(rng.integers(bsz)), o, int(rng.integers(1, s - 1)),
                    int(rng.integers(1, h - 1)), int(rng.integers(1, w - 1))))
    return out


@pytest.mark.parametrize("space", ["cube_rows", "stack", "resident_b16", "cli_pair"])
def test_space_index_is_each_spaces_index(crop_spaces, space):
    """The kernel's index rule (``space_index``, in plain Python) gives each
    space's own ``index`` for every element of random cubes, with the
    window start of gather_cubes (x - 1)."""
    cfg, spaces = crop_spaces
    if space in spaces:
        sp, bsz = spaces[space][0], 2
    else:
        bsz, h, w, caps = CELLS[space]
        sp = cube_rows_at(SiftConfig(**caps), bsz, h, w)
    lay = DJ.layout_of(sp)
    cases = _index_cases(sp, bsz, 300, seed=len(space))
    d = (-1, 0, 1)
    want = sp.index(*(torch.tensor([[c[i]] * 27 for c in cases]) for i in (0, 1)),
                    torch.tensor([[c[2] + a for a in d for _ in d for _ in d] for c in cases]),
                    torch.tensor([[c[3] + b for _ in d for b in d for _ in d] for c in cases]),
                    torch.tensor([[c[4] + e for _ in d for _ in d for e in d] for c in cases]),
                    torch.tensor([[c[4] - 1] * 27 for c in cases]))
    got = [[DJ.space_index(lay, o, img, z + a, y + b, x + e, x - 1)
            for a in d for b in d for e in d] for img, o, z, y, x in cases]
    assert want.tolist() == got


@pytest.mark.parametrize("space", ["cube_rows", "stack"])
def test_space_index_reads_gather_cubes_values(crop_spaces, space):
    """Through the kernel's index rule the flat buffer gives the cubes that
    ``gather_cubes`` reads, clamps included (positions on and past the
    border)."""
    cfg, spaces = crop_spaces
    sp = spaces[space][0]
    lay = DJ.layout_of(sp)
    cases = _index_cases(sp, 2, 200, seed=7)
    cases += [(1, o, 0, 0, 0) for o in range(len(sp.shapes))]
    cases += [(0, o, s, h - 1, w - 1) for o, (s, h, w) in enumerate(sp.shapes)]
    img, oc, z, y, x = (torch.tensor([c[i] for c in cases]) for i in range(5))
    want = gather_cubes(sp, img, oc, torch.stack([z, y, x], -1)).reshape(len(cases), 27)
    flat = sp.flat
    for k, (i, o, zz, yy, xx) in enumerate(cases):
        s, h, w = sp.shapes[o]
        zc, yc, xc = min(max(zz, 1), s - 2), min(max(yy, 1), h - 2), min(max(xx, 1), w - 2)
        got = [flat[DJ.space_index(lay, o, i, zc + a, yc + b, xc + e, xc - 1)]
               for a in (-1, 0, 1) for b in (-1, 0, 1) for e in (-1, 0, 1)]
        assert torch.equal(torch.stack(got), want[k])


def _fault(name, cfg, sp, masks, counts):
    """One input the kernel does not take (on the CPU: the wrapper must
    refuse it before it looks at the device)."""
    if name == "space_kind":
        return cfg, S.front_twin(crop_batch()[1], cfg)[0], masks, counts
    if name == "space_dtype":
        return cfg, dataclasses.replace(sp, rows=sp.rows.double()), masks, counts
    if name == "space_contiguity":  # a StackSpace's flat buffer, one value in two
        stack = StackSpace.build(S.front(crop_batch()[1], cfg)[1])
        flat = torch.empty(2 * stack.flat.numel())[::2]
        flat.copy_(stack.flat)
        return cfg, dataclasses.replace(stack, flat=flat), masks, counts
    if name == "window":
        return dataclasses.replace(cfg, window_size=5), sp, masks, counts
    if name == "octaves":
        return cfg, sp, masks[:-1], counts[:-1]
    if name == "counts_dtype":
        return cfg, sp, masks, [counts[0].long()] + counts[1:]
    if name == "counts_shape":
        return cfg, sp, masks, [counts[0][:, :, :-1]] + counts[1:]
    if name == "masks_dtype":
        return cfg, sp, [masks[0].double()] + masks[1:], counts
    if name == "masks_shape":
        return cfg, sp, [masks[0][..., :-128]] + masks[1:], counts
    if name == "masks_contiguity":
        m = masks[1]
        m = m.transpose(2, 3).contiguous().transpose(2, 3)
        return cfg, sp, [masks[0], m] + masks[2:], counts
    if name == "batch":
        return cfg, sp, [m[:1] for m in masks], [c[:1] for c in counts]
    if name == "extrema_cap":
        return dataclasses.replace(cfg, extrema_cap=DJ.MAX_LANES + 1), sp, masks, counts
    raise AssertionError(name)


FAULTS = ["space_kind", "space_dtype", "space_contiguity", "window", "octaves", "counts_dtype",
          "counts_shape", "masks_dtype", "masks_shape", "masks_contiguity", "batch",
          "extrema_cap"]


@pytest.mark.parametrize("fault", FAULTS)
def test_wrapper_rejects_before_the_device(crop_spaces, fault):
    cfg, spaces = crop_spaces
    args = _fault(fault, cfg, *spaces["cube_rows"])
    with pytest.raises((TypeError, ValueError)) as err:
        DJ.detect_kernel(args[1], args[2], args[3], args[0])
    assert "one card" not in str(err.value)


def test_wrapper_takes_a_sound_input_to_the_device_check(crop_spaces):
    """A sound input on the CPU passes every check but the device's."""
    cfg, spaces = crop_spaces
    for sp, masks, counts in spaces.values():
        with pytest.raises(ValueError, match="one card"):
            DJ.detect_kernel(sp, masks, counts, cfg)


def _fake(space, dtype=torch.float32, device="cuda"):
    """A space whose ``flat`` only names a dtype and a device."""
    flat = types.SimpleNamespace(dtype=dtype, device=torch.device(device))
    if isinstance(space, StackSpace):
        return dataclasses.replace(space, flat=flat)
    fake = type("FakeRows", (type(space),), {"flat": property(lambda self: flat)})
    return fake(**{f.name: getattr(space, f.name) for f in dataclasses.fields(space)})


@pytest.mark.parametrize("case", ["cube_rows", "stack", "cpu", "float64", "window5",
                                  "multi_rows"])
def test_dispatch_rule(crop_spaces, case):
    """Kernel J for a float32 ``CubeRows`` or ``StackSpace`` on the card at
    window 3; the plain chain for the CPU, float64, another window or
    another space."""
    cfg, spaces = crop_spaces
    cube = spaces["cube_rows"][0]
    sp = {"cube_rows": _fake(cube), "stack": _fake(spaces["stack"][0]),
          "cpu": cube, "float64": _fake(cube, torch.float64), "window5": _fake(cube),
          "multi_rows": S.front_twin(crop_batch()[1], cfg)[0]}[case]
    c = dataclasses.replace(cfg, window_size=5) if case == "window5" else cfg
    assert DJ.applies(sp, c) == (case in ("cube_rows", "stack"))


def _never(*a, **k):
    raise AssertionError("kernel J was called")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("route", ["front_twin", "front"])
def test_cpu_takes_the_plain_chain(monkeypatch, dtype, route):
    """On the CPU, float32 or float64, ``detect_refine`` returns the plain
    chain's result unchanged and never reaches the kernel."""
    monkeypatch.setattr(S, "detect_kernel", _never)
    cfg, imgs = crop_batch(dtype)
    if route == "front_twin":
        _, sp, masks, counts = S.front_twin(imgs, cfg)
    else:
        _, dogs, masks, counts = S.front(imgs, cfg)
        sp = StackSpace.build(dogs)
    kp, c = S.detect_refine(sp, masks, counts, cfg)
    want, wc = S._refine(sp, *Dt.extrema_from_counts(masks, counts, cfg.extrema_cap), cfg)
    for f in FIELDS:
        assert torch.equal(getattr(kp, f), getattr(want, f)), f
    for k in wc:
        assert torch.equal(c[k], wc[k]), k
    assert int(kp.valid.sum()) > 0


def test_the_fused_route_never_takes_the_kernel(monkeypatch, crop_spaces):
    """With the dispatch rule forced on, ``detect_refine`` reaches the
    kernel, and the non-front routes' ``_detect_refine_fused`` still runs
    the plain chain."""
    cfg, spaces = crop_spaces
    monkeypatch.setattr(S, "detect_kernel_applies", lambda sp, c: True)
    monkeypatch.setattr(S, "detect_kernel", _never)
    with pytest.raises(AssertionError, match="kernel J was called"):
        S.detect_refine(*spaces["cube_rows"], cfg)
    _, dogs = S.pyramids(crop_batch()[1], cfg)
    for twin_rows in (False, True):
        kp, _ = S._detect_refine_fused(dogs, cfg, twin_rows)
        assert int(kp.valid.sum()) > 0
