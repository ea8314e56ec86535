"""The port's cube-packed DoG rows (``gather.cube_rows_plain``, the plain
version of kernel G, and the ``CubeRows`` gather space) against the JAX
package: ``gather.cube_rows_xla``, the Pallas kernel
``pallas_relayout.cube_pack_rows`` in interpret mode and
``gather.gather_cubes_packed``.  Pure data movement: every tolerance is
none."""

from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.ops import gather as JG
from sift_tpu.ops.pallas_relayout import cube_pack_rows as jax_cube_pack_rows
from sift_tpu_torch import kernels
from sift_tpu_torch.ops import cube_pack as CP
from sift_tpu_torch.ops.cube_pack import cube_pack_rows
from sift_tpu_torch.ops.gather import (
    CubeRows,
    StackSpace,
    cube_rows_params,
    cube_rows_plain,
    from_reference_space,
    gather_cubes,
)

torch.set_num_threads(2)
# (B, S, H, W): w = 69 has (w - 3) % stride == 0 (the extra last block), 150
# is no multiple of anything, 23 is narrower than one block.
CASES = {"w69": (2, 5, 37, 69), "w150": (2, 5, 20, 150), "w23": (1, 5, 9, 23)}


def _dog(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("n,w", [(n, w) for n in (5, 6) for w in (1, 2, 3, 25, 69, 70, 1280)])
def test_cube_rows_params_equal_jax(n, w):
    assert cube_rows_params(n, w) == JG.cube_rows_params(n, w)


@pytest.mark.parametrize("strip", [1, 8, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_cube_rows_plain_equals_jax_versions(case, strip):
    """cube_rows_plain == cube_rows_xla on the whole buffer (both zero the
    rows past H), == the Pallas kernel on rows of image rows < H (its other
    rows are padding), and kernel G's wrapper takes the plain version on a
    CPU tensor without counting a launch."""
    d = _dog(CASES[case])
    got = cube_rows_plain(torch.from_numpy(d), strip).numpy()
    np.testing.assert_array_equal(got, np.asarray(JG.cube_rows_xla(jnp.asarray(d), strip)))
    _, _, nbp = cube_rows_params(d.shape[1], d.shape[3])
    row = np.arange(got.shape[1])
    y = (row // strip // nbp) * strip + row % strip
    pallas = np.asarray(jax_cube_pack_rows(jnp.asarray(d), strip, interpret=True))
    assert pallas.shape == got.shape
    np.testing.assert_array_equal(got[:, y < d.shape[2]], pallas[:, y < d.shape[2]])
    before = kernels.launch_counts()["cube_pack"]
    np.testing.assert_array_equal(cube_pack_rows(torch.from_numpy(d), strip).numpy(), got)
    assert kernels.launch_counts()["cube_pack"] == before


def test_cube_pack_rows_writes_its_region_in_place():
    """With ``out`` and ``base`` only the octave's rows change; a base off
    the layout's grid, a short buffer and an unknown device raise."""
    d = torch.from_numpy(_dog(CASES["w69"], seed=1))
    want = cube_rows_plain(d, 8)
    n = want.shape[1]
    unit = cube_rows_params(5, 69)[2] * 8
    out = torch.full((2, n + 3 * unit, 128), -7.0)
    assert cube_pack_rows(d, 8, out=out, base=2 * unit) is out
    assert torch.equal(out[:, 2 * unit: 2 * unit + n], want)
    assert bool((out[:, : 2 * unit] == -7).all()) and bool((out[:, 2 * unit + n:] == -7).all())
    with pytest.raises(ValueError, match="out / base"):
        cube_pack_rows(d, 8, out=out, base=unit + 1)
    with pytest.raises(ValueError, match="out / base"):
        cube_pack_rows(d, 8, out=out, base=4 * unit)
    with pytest.raises(ValueError, match="unsupported device"):
        cube_pack_rows(d.to("meta"), 8)


# Per-octave (S, H, W) volumes of one image, and the strips of the
# strip-block-major case; widths 69 and 1280 pin cb for x = w - 2.
SHAPES = [(5, 40, 200), (5, 12, 1280), (5, 9, 23), (5, 40, 69)]
STRIPS = {"ymajor": (1, 1, 1, 1), "strips": (16, 8, 8, 32)}


def _spaces(strips, batch=2, seed=2):
    """One buffer of cube-packed rows for ``batch`` images (octave bases
    aligned as the front-twin route aligns them), as the JAX package's
    CubeRows (per image) and the port's, plus the plain stacks."""
    rng = np.random.default_rng(seed)
    vols = [rng.normal(size=(batch,) + s).astype(np.float32) for s in SHAPES]
    bases, nbps, acc = [], [], 0
    for s, st in zip(SHAPES, strips):
        stride, sw, nbp = cube_rows_params(s[0], s[2])
        acc = -(-acc // (nbp * st)) * (nbp * st)
        bases.append(acc)
        nbps.append(nbp)
        acc += -(-s[1] // st) * st * nbp
    buf = torch.zeros((batch, acc, 128))
    for v, st, base in zip(vols, strips, bases):
        cube_pack_rows(torch.from_numpy(v), st, out=buf, base=base)
    lss = tuple(st.bit_length() - 1 for st in strips)
    mine = CubeRows(rows=buf, shapes=tuple(SHAPES), nbps=tuple(nbps), bases=tuple(bases),
                    stride=stride, sw=sw, lss=lss)
    theirs = [JG.CubeRows(rows=jnp.asarray(buf[i].numpy()), shapes=tuple(SHAPES),
                          nbps=tuple(nbps), bases=tuple(bases), stride=stride, sw=sw, lss=lss)
              for i in range(batch)]
    return mine, theirs, StackSpace.build([torch.from_numpy(v) for v in vols])


def _interior_lanes(n, seed=3):
    rng = np.random.default_rng(seed)
    oct_id = rng.integers(0, len(SHAPES), n)
    oct_id[: len(SHAPES)] = np.arange(len(SHAPES))
    hs = np.array([SHAPES[o][1] for o in oct_id])
    ws = np.array([SHAPES[o][2] for o in oct_id])
    z = rng.integers(1, 4, n)
    y = 1 + rng.integers(0, 1000, n) % (hs - 2)
    x = 1 + rng.integers(0, 5000, n) % (ws - 2)
    x[: len(SHAPES)] = ws[: len(SHAPES)] - 2  # the last interior column of every octave
    return oct_id, np.stack([z, y, x], -1)


@pytest.mark.parametrize("order", list(STRIPS))
def test_gather_cubes_over_cube_rows_equals_jax_and_stacks(order):
    """gather_cubes over the port's CubeRows == the JAX package's
    gather_cubes_packed on the same buffer == the port's StackSpace, and the
    JAX space converted by from_reference_space reads the same."""
    mine, theirs, stacks = _spaces(STRIPS[order])
    oct_id, zyx = _interior_lanes(400)
    t_oct, t_zyx = torch.from_numpy(oct_id), torch.from_numpy(zyx)
    for i, cr in enumerate(theirs):
        img = torch.full((len(oct_id),), i)
        got = gather_cubes(mine, img, t_oct, t_zyx)
        want = JG.gather_cubes_packed(cr, jnp.asarray(oct_id, jnp.int32),
                                      jnp.asarray(zyx, jnp.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, gather_cubes(stacks, img, t_oct, t_zyx))
        conv = from_reference_space(cr)
        assert torch.equal(got, gather_cubes(conv, torch.zeros_like(img), t_oct, t_zyx))


def test_gather_cubes_clamps_positions_like_the_stacks():
    """Border and out-of-volume positions (lanes whose values are never
    used) are clamped for the read: same cubes as from the plain stacks,
    and no index leaves the buffer."""
    mine, _, stacks = _spaces(STRIPS["strips"], seed=4)
    rng = np.random.default_rng(5)
    n = 300
    oct_id = torch.from_numpy(rng.integers(0, len(SHAPES), n))
    img = torch.from_numpy(rng.integers(0, 2, n))
    zyx = torch.from_numpy(np.stack([rng.integers(-1, 7, n), rng.integers(-3, 60, n),
                                     rng.integers(-3, 1400, n)], -1))
    assert torch.equal(gather_cubes(mine, img, oct_id, zyx), gather_cubes(stacks, img, oct_id, zyx))


# Kernel G's schedule (ops/cube_pack.walk_plain): (B, S, H, W), strip, and
# the octave's base in units of nbp * strip rows.  S 4, 5 and 6 (sw 32, 25,
# 21); widths 23 (one block), 69 (the extra last block), 150, 755 (odd: the
# kernel's 4-byte staging) and 20,480 (72 chunks of 13 blocks, the wide
# fallback octave's width at 9 rows); H not a multiple of the strip; strips
# of 1 row (units span strips) up to 128 (past H by more than a unit).
WALK_CASES = {
    "s5_w69_st8": ((2, 5, 37, 69), 8, 1),
    "s4_w23_st1": ((2, 4, 13, 23), 1, 2),
    "s6_w150_st64": ((2, 6, 20, 150), 64, 1),
    "s5_w755_st128": ((1, 5, 70, 755), 128, 2),
    "s4_w755_st8": ((1, 4, 33, 755), 8, 0),
    "s6_w69_st1": ((2, 6, 9, 69), 1, 3),
    "s5_w150_st1": ((1, 5, 21, 150), 1, 1),
    "s6_w23_st128": ((2, 6, 5, 23), 128, 1),
    "s5_w20480_st128": ((1, 5, 9, 20480), 128, 1),
    "s4_w20480_st8": ((1, 4, 9, 20480), 8, 2),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_plain_writes_each_row_of_its_region_once(case):
    """Kernel G's schedule into a NaN-filled shared buffer at an in-place
    base: every row of the octave's region written exactly once, no row
    outside it, and the region equal to cube_rows_plain, to the JAX
    package's cube_rows_xla, and on the rows of image rows < H to the Pallas
    kernel in interpret mode (below nbp 100: it unrolls its blocks).
    Tolerance: none."""
    shape, strip, units = WALK_CASES[case]
    d = _dog(shape, seed=7)
    b, s, h, w = shape
    _, _, nbp = cube_rows_params(s, w)
    want = cube_rows_plain(torch.from_numpy(d), strip)
    n = want.shape[1]
    base = units * nbp * strip
    out = torch.full((b, base + n + nbp * strip, 128), float("nan"))
    writes = CP.walk_plain(torch.from_numpy(d), strip, out, base)
    assert (writes[:, base: base + n] == 1).all()
    assert not writes[:, :base].any() and not writes[:, base + n:].any()
    assert torch.isnan(out[:, :base]).all() and torch.isnan(out[:, base + n:]).all()
    got = out[:, base: base + n].numpy()
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, np.asarray(JG.cube_rows_xla(jnp.asarray(d), strip)))
    if nbp < 100:
        row = np.arange(n)
        y = (row // strip // nbp) * strip + row % strip
        pallas = np.asarray(jax_cube_pack_rows(jnp.asarray(d), strip, interpret=True))
        np.testing.assert_array_equal(got[:, y < h], pallas[:, y < h])


def test_schedule_constants_mirror_the_kernel():
    """The constants walk_plain and ``chunking`` use are the kernel
    source's; every unit's staged tile fits TILE_FLOATS (the kernel's
    shared memory), the chunks cover the blocks and none is empty, and one
    warp writes each of a unit's rows."""
    src = (pathlib.Path(CP.__file__).parent.parent / "csrc" / "cube_pack.cu").read_text()
    for name in ("ROWS", "THREADS", "TILE_FLOATS"):
        assert re.search(rf"^#define {name} (\d+)", src, re.M).group(1) == str(getattr(CP, name))
    assert CP.THREADS // 32 == CP.ROWS
    for n in range(1, 33):
        stride, _, _ = cube_rows_params(n, 1)
        if stride < 1:
            continue
        for w in (3, 23, 69, 150, 755, 1280, 20480, 40000):
            nbp = cube_rows_params(n, w)[2]
            nbc, nchunks = CP.chunking(n, nbp, stride)
            assert n * CP.ROWS * CP.tile_width(nbc, stride) <= CP.TILE_FLOATS
            assert (nchunks - 1) * nbc < nbp <= nchunks * nbc
    # The wide fallback octave's chunks: 13 blocks of 22 columns, 72 a row.
    assert CP.chunking(5, 931, 22) == (13, 72)
