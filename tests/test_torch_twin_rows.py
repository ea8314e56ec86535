"""The port's twin-row gather space (the plain version of kernel E) against
the JAX package: ``ops/pallas_relayout.twin_rows_strips`` in interpret
mode, its row contents against ``ops/gather.build_multi_rows``, and the
gathers and the non-front route on it against the plain stacks; and the
table kernel E is launched with, walked as the kernel walks it."""

from __future__ import annotations

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.ops.gather import build_multi_rows
from sift_tpu.ops.pallas_relayout import twin_rows_strips as jax_twin_rows_strips
from sift_tpu_torch import SiftConfig, kernels
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.ops import twin_rows as TR
from sift_tpu_torch.ops.gather import StackSpace, gather_cubes, gather_patches
from sift_tpu_torch.ops.twin_rows import twin_rows_strips
from sift_tpu_torch.utils.keypoints import FIELDS

torch.set_num_threads(2)
DATA = pathlib.Path(__file__).parent / "data"
# (per-octave (B, S, H, W) shapes, blk): a halving pyramid with widths
# that are not multiples of blk, and the route's blk of 64.
CASES = {
    "blk16": ([(3, 5, 24, 40), (3, 5, 12, 20)], 16),
    "blk64": ([(2, 6, 37, 130), (2, 6, 18, 65), (2, 6, 9, 32)], 64),
}


def _stacks(shapes, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, s).astype(dtype) for s in shapes]


def _defined_rows(mr):
    """(octave, flat row r, block b, buffer row) of every row the layout
    defines (rows past S * H in a strip's padding are not)."""
    for o, (s, h, _) in enumerate(mr.shapes):
        nb, ls = mr.nbs[o], mr.shp[o]
        r = np.arange(s * h)[:, None]
        b = np.arange(nb)[None, :]
        row = mr.bases[o] + (((r >> ls) * nb + b) << ls) + (r & ((1 << ls) - 1))
        yield o, r, b, row


@pytest.mark.parametrize("case", list(CASES))
def test_twin_rows_equal_pallas_interpret(case):
    """Same layout (nbs, strips, bases, buffer rows) and the same bits on
    every defined row as the Pallas kernel.  Tolerance: none."""
    shapes, blk = CASES[case]
    vols = _stacks(shapes)
    want = jax_twin_rows_strips([jnp.asarray(v) for v in vols], blk, interpret=True)
    got = twin_rows_strips([torch.from_numpy(v) for v in vols], blk)
    assert (got.shapes, got.nbs, got.bases, got.shp) == (want.shapes, want.nbs, want.bases, want.shp)
    assert tuple(got.rows.shape) == tuple(want.rows.shape)
    w_rows, g_rows = np.asarray(want.rows), got.rows.numpy()
    for _, _, _, row in _defined_rows(got):
        np.testing.assert_array_equal(g_rows[:, row], w_rows[:, row])


@pytest.mark.parametrize("case", list(CASES))
def test_twin_rows_hold_build_multi_rows_values(case):
    """Every defined row equals the JAX package's row-major twin row of the
    same (image, octave, flat row, block), and every row outside the
    layout is zero.  Tolerance: none."""
    shapes, blk = CASES[case]
    vols = _stacks(shapes, seed=1)
    ref = jax.vmap(lambda *v: build_multi_rows(list(v), blk=blk))(*map(jnp.asarray, vols))
    got = twin_rows_strips([torch.from_numpy(v) for v in vols], blk)
    ref_rows, g_rows = np.asarray(ref.rows), got.rows.numpy()
    seen = np.zeros(g_rows.shape[1], bool)
    for o, r, b, row in _defined_rows(got):
        np.testing.assert_array_equal(
            g_rows[:, row], ref_rows[:, ref.bases[o] + r * ref.nbs[o] + b], err_msg=f"octave {o}")
        seen[row.reshape(-1)] = True
    assert not g_rows[:, ~seen].any()


@pytest.fixture(scope="module", params=["float32", "float64"])
def spaces(request):
    shapes, blk = CASES["blk16"]
    vols = [torch.from_numpy(v) for v in _stacks(shapes, getattr(np, request.param), seed=2)]
    return twin_rows_strips(vols, blk), StackSpace.build(vols)


def _lanes(n, seed=3):
    """Random (image, octave, layer, y, x) lanes over CASES["blk16"]."""
    rng = np.random.default_rng(seed)
    oct_id = rng.integers(0, 2, n)
    h, w = np.where(oct_id == 0, 24, 12), np.where(oct_id == 0, 40, 20)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))  # noqa: E731
    return dict(img=t(rng.integers(0, 3, n)), oct_id=t(oct_id), layer=t(rng.integers(0, 5, n)),
                y=t(rng.integers(0, 1000, n) % h), x=t(rng.integers(0, 1000, n) % w),
                ys0=t(rng.integers(-6, 20, n)), xs0=t(rng.integers(-8, 40, n)))


def test_cube_gathers_equal_stack_space(spaces):
    """3x3x3 cubes, clamped positions included.  Tolerance: none."""
    mr, sp = spaces
    ln = _lanes(200)
    zyx = torch.stack([ln["layer"], ln["y"], ln["x"]], -1)
    got = gather_cubes(mr, ln["img"], ln["oct_id"], zyx)
    assert got.shape == (200, 3, 3, 3)
    assert torch.equal(got, gather_cubes(sp, ln["img"], ln["oct_id"], zyx))


@pytest.mark.parametrize("patch", [9, 17, 33])
def test_patch_gathers_equal_stack_space(spaces, patch):
    """One twin row (9), the blk + 1 boundary (17) and windows wider than
    a twin row (33, the descriptor's case at blk 64), rows and columns
    clamped at the borders.  Tolerance: none."""
    mr, sp = spaces
    ln = _lanes(120, seed=4)
    args = (ln["img"], ln["oct_id"], ln["layer"], ln["ys0"], ln["xs0"], patch)
    got = gather_patches(mr, *args)
    assert got.shape == (120, patch, patch)
    assert torch.equal(got, gather_patches(sp, *args))


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors kernel E's wrapper runs the plain version and counts
    no launch; it refuses a device it has no path for."""
    vols = [torch.from_numpy(v) for v in _stacks(CASES["blk16"][0])]
    before = kernels.launch_counts()["twin_rows"]
    twin_rows_strips(vols, 16)
    assert kernels.launch_counts()["twin_rows"] == before
    with pytest.raises(ValueError, match="unsupported device"):
        twin_rows_strips([v.to("meta") for v in vols], 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_twin_rows_route_equals_stacks_route(dtype):
    """The non-front route gives the same final buffer and counts from the
    twin rows (its layout on the card in float32) as from the plain stacks.
    Tolerance: none."""
    small = dict(np.load(DATA / "oracle_small.npz"))["input"]
    cfg = SiftConfig(dtype=dtype, extrema_cap=1024, kp_cap=512, ori_cap=2048)
    imgs = S.as_batch(np.stack([small, small[::-1]]), cfg, "cpu")
    a, ca = S.run_route(imgs, cfg, "twin_rows")
    b, cb = S.run_route(imgs, cfg, "stacks")
    assert int(a.valid.sum()) > 0
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for k in ca:
        assert torch.equal(torch.as_tensor(ca[k]), torch.as_tensor(cb[k])), k


# Kernel E's launch table: per-octave (B, S, H, W) shapes at B = 2 and blk,
# with the widths 1, 10, 63, 64, 65, 130, 755 and 1510 (two block chunks at
# blk 128), one-row octaves, three or more octaves and alignment gaps.
TABLE_CASES = {
    "blk64": ([(2, 2, 3, 65), (2, 2, 17, 130), (2, 2, 2, 10), (2, 2, 1, 755), (2, 1, 1, 1)], 64),
    "blk128": ([(2, 2, 3, 64), (2, 2, 17, 65), (2, 2, 2, 63), (2, 1, 1, 1)], 128),
    "blk128_wide": ([(2, 2, 3, 10), (2, 2, 17, 130), (2, 2, 2, 755), (2, 1, 3, 1510)], 128),
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_launch_table_walk_writes_every_row_once(case):
    """The table kernel E's wrapper launches, walked unit by unit as the
    kernel walks it (``walk_plain``) into a NaN-filled buffer: every row,
    gaps and strip padding included, written exactly once; the buffer
    equals ``twin_rows_strips_plain`` and, on every defined row, the
    Pallas kernel in interpret mode.  Tolerance: none."""
    shapes, blk = TABLE_CASES[case]
    vols = [torch.from_numpy(v) for v in _stacks(shapes, seed=5)]
    table = TR.strips_table(tuple(s[1:] for s in shapes), blk)
    assert sum(e.src >= 0 for e in table.regions) == len(shapes) >= 3
    assert any(e.src < 0 for e in table.regions), "no alignment gap in this case"
    out = torch.full((2, table.rows, 2 * blk), float("nan"))
    writes = TR.walk_plain(table, vols, out)
    assert (writes == 1).all()
    plain = TR.twin_rows_strips_plain(vols, blk)
    assert torch.equal(out, plain.rows)
    want = jax_twin_rows_strips([jnp.asarray(v.numpy()) for v in vols], blk, interpret=True)
    w_rows, o_rows = np.asarray(want.rows), out.numpy()
    for _, _, _, row in _defined_rows(plain):
        np.testing.assert_array_equal(o_rows[:, row], w_rows[:, row])


def test_table_limits_mirror_the_kernel():
    """The constants the tables are built with are the kernel source's;
    every table keeps a unit's staged tile within TILE_FLOATS and its block
    chunks non-empty, and none holds more regions than a launch takes."""
    src = (pathlib.Path(TR.__file__).parent.parent / "csrc" / "twin_rows.cu").read_text()
    for name in ("ROWS", "TILE_FLOATS", "MAX_REGIONS", "MAX_BLK"):
        assert re.search(rf"^#define {name} (\d+)", src, re.M).group(1) == str(getattr(TR, name))
    for shapes, blk in list(TABLE_CASES.values()) + [
            ([(16, 6, 960, 1280), (16, 6, 480, 640)], 64), ([(2, 6, 1996, 3020)], 64)]:
        for e in TR.strips_table(tuple(s[1:] for s in shapes), blk).regions:
            assert TR.ROWS * (e.nbc + 1) * blk <= TR.TILE_FLOATS
            assert (e.nchunks - 1) * e.nbc < e.nb <= e.nchunks * e.nbc
            assert e.rpad % (1 << e.ls) == 0
            assert e.ls == 0 or (1 << e.ls) % TR.ROWS == 0  # a unit's rows lie in one strip
    with pytest.raises(ValueError, match="at most 64"):
        TR.rows_table(((3, 10),) * (TR.MAX_REGIONS + 1), 64)
