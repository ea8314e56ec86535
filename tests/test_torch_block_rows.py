"""The port's row-major twin rows (``twin_rows_2d_plain``, the plain version
of kernel H; ``BlockRows``; the row-major ``MultiRows``) against the JAX
package: the Pallas kernel ``pallas_relayout.twin_rows_2d`` in interpret
mode, ``gather.build_block_rows`` / ``build_multi_rows`` and their gathers;
the table kernel H is launched with, walked as the kernel walks it;
and the staged path's stages over those rows against the same stages over
plain stacks.  Pure data movement: every tolerance is none."""

from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.ops import gather as JG
from sift_tpu.ops.pallas_relayout import twin_rows_2d as jax_twin_rows_2d
from sift_tpu_torch import SiftConfig, kernels
from sift_tpu_torch.models.descriptor import compute_descriptors_all
from sift_tpu_torch.models.orient import orient_all
from sift_tpu_torch.models.sift import detect_stages
from sift_tpu_torch.ops.gather import (
    StackSpace,
    build_block_rows,
    build_multi_rows,
    from_reference_space,
    gather_cubes,
    gather_patches,
)
from sift_tpu_torch.ops import twin_rows as TR
from sift_tpu_torch.ops.twin_rows import twin_rows_2d, twin_rows_2d_plain
from sift_tpu_torch.utils import keypoints as kputil

torch.set_num_threads(2)
DATA = pathlib.Path(__file__).parent / "data"
# ((S, H, W), blk): widths that are no multiple of blk, one narrower than blk.
CASES = {"blk16": ((5, 24, 40), 16), "blk64": ((6, 37, 130), 64), "blk128": ((3, 9, 150), 128)}


def _vol(shape, dtype=np.float32, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(dtype)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_rows_2d_equals_jax(case):
    """twin_rows_2d_plain == the Pallas kernel == the rows of the JAX
    package's plain build_block_rows; the wrapper takes the plain version
    on a CPU tensor and counts no launch."""
    (s, h, w), blk = CASES[case]
    vol = _vol((s, h, w))
    mat = torch.from_numpy(vol.reshape(s * h, w))
    got = twin_rows_2d_plain(mat, blk).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_twin_rows_2d(jnp.asarray(mat.numpy()), blk, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(JG.build_block_rows(jnp.asarray(vol), blk).rows))
    before = kernels.launch_counts()["twin_rows_2d"]
    assert torch.equal(twin_rows_2d(mat, blk), torch.from_numpy(got))
    assert kernels.launch_counts()["twin_rows_2d"] == before
    with pytest.raises(ValueError, match="unsupported device"):
        twin_rows_2d(mat.to("meta"), blk)


SHAPES = [(5, 24, 150), (5, 12, 75), (5, 6, 37)]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel_wrapper"])
@pytest.mark.parametrize("blk", [64, 128])
def test_build_rows_equal_jax(blk, use_pallas):
    """build_block_rows and build_multi_rows: the JAX package's fields and
    rows, built there with and without its kernel (use_pallas, in interpret
    mode on the CPU).  The port's builders choose by the volume itself:
    float32 through kernel H's wrapper (use_pallas case), which takes the
    plain version on a CPU tensor, and float64 (plain case) straight to the
    plain version; the rows hold the same float32 values either way."""
    vols = [_vol(s, seed=i) for i, s in enumerate(SHAPES)]
    want = JG.build_multi_rows([jnp.asarray(v) for v in vols], blk, use_pallas=use_pallas)
    dtype = torch.float32 if use_pallas else torch.float64
    got = build_multi_rows([torch.from_numpy(v).to(dtype) for v in vols], blk)
    assert got.rows.dtype == dtype
    assert (got.shapes, got.blk, got.nbs, got.bases) == (want.shapes, want.blk, want.nbs, want.bases)
    assert got.shp is None and got.nls is None and got.unit == 1
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    one = build_block_rows(torch.from_numpy(vols[0]).to(dtype), blk)
    ref = JG.build_block_rows(jnp.asarray(vols[0]), blk, use_pallas=use_pallas)
    assert (one.shape, one.blk, one.nb) == (ref.shape, ref.blk, ref.nb)
    np.testing.assert_array_equal(one.rows.numpy(), np.asarray(ref.rows))


def _lanes(n, seed):
    rng = np.random.default_rng(seed)
    oct_id = rng.integers(0, len(SHAPES), n)
    hs = np.array([SHAPES[o][1] for o in oct_id])
    ws = np.array([SHAPES[o][2] for o in oct_id])
    return rng, oct_id, hs, ws


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cube_gathers_over_block_rows(dtype):
    """gather_cubes over BlockRows == the JAX package's gather_cubes on the
    same rows == the port's StackSpace, interior positions; clamped ones
    against the StackSpace; the converted JAX space reads the same."""
    vol = _vol(SHAPES[0], getattr(np, dtype), seed=6)
    br = build_block_rows(torch.from_numpy(vol), 64)
    sp = StackSpace.build([torch.from_numpy(vol)[None]])
    rng = np.random.default_rng(7)
    n = 200
    s, h, w = SHAPES[0]
    zyx = np.stack([rng.integers(1, s - 1, n), rng.integers(1, h - 1, n),
                    rng.integers(1, w - 1, n)], -1)
    zyx[0] = (1, 1, w - 2)
    zero = torch.zeros(n, dtype=torch.int64)
    got = gather_cubes(br, zero, zero, torch.from_numpy(zyx))
    assert torch.equal(got, gather_cubes(sp, zero, zero, torch.from_numpy(zyx)))
    jbr = JG.build_block_rows(jnp.asarray(vol), 64)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JG.gather_cubes(jbr, jnp.asarray(zyx, jnp.int32))))
    assert torch.equal(got, gather_cubes(from_reference_space(jbr), zero, zero,
                                         torch.from_numpy(zyx)))
    wild = torch.from_numpy(np.stack([rng.integers(-1, s + 1, n), rng.integers(-2, h + 2, n),
                                      rng.integers(-2, w + 2, n)], -1))
    assert torch.equal(gather_cubes(br, zero, zero, wild), gather_cubes(sp, zero, zero, wild))


@pytest.mark.parametrize("patch", [9, 33, 83])
def test_patch_gathers_over_row_major_multi_rows(patch):
    """Patches of the orientation's and the descriptor's widths (83 columns
    is wider than a blk-64 twin row) over the row-major MultiRows at blk 64:
    == the port's StackSpace everywhere (rows and columns clamped), windows
    at the right edge included; == the JAX package's gather_patches_multi
    on the columns inside the image (outside it JAX reads zeros where the
    port clamps; callers mask those samples), also through
    from_reference_space."""
    vols = [_vol(s, seed=10 + i) for i, s in enumerate(SHAPES)]
    tv = [torch.from_numpy(v) for v in vols]
    mr = build_multi_rows(tv, 64)
    sp = StackSpace.build([v[None] for v in tv])
    rng, oct_id, hs, ws = _lanes(150, seed=11)
    layer = rng.integers(0, 5, len(oct_id))
    ys0 = rng.integers(-6, 30, len(oct_id)) % (hs + 8) - 6
    xs0 = rng.integers(-8, 200, len(oct_id)) % (ws + 8) - 8
    xs0[:20] = ws[:20] - rng.integers(1, patch, 20)  # windows hanging off the right edge
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))  # noqa: E731
    zero = torch.zeros(len(oct_id), dtype=torch.int64)
    args = (zero, t(oct_id), t(layer), t(ys0), t(xs0), patch)
    got = gather_patches(mr, *args)
    assert torch.equal(got, gather_patches(sp, *args))
    jmr = JG.build_multi_rows([jnp.asarray(v) for v in vols], 64)
    want = np.asarray(JG.gather_patches_multi(
        jmr, *(jnp.asarray(a, jnp.int32) for a in (oct_id, layer, ys0, xs0)), patch))
    cols = xs0[:, None] + np.arange(patch)[None, :]
    inside = np.broadcast_to(((cols >= 0) & (cols < ws[:, None]))[:, None, :], want.shape)
    np.testing.assert_array_equal(got.numpy()[inside], want[inside])
    assert torch.equal(got, gather_patches(from_reference_space(jmr), *args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_staged_stages_over_rows_equal_stages_over_stacks(dtype):
    """The staged path's orientation and descriptor stages, which gather
    from each octave's row-major twin rows, give lane for lane what the
    same stages give over the octave's plain stack (in float64 the staged
    path is held to the oracle's stage dumps by test_torch_stages)."""
    oracle = dict(np.load(DATA / "oracle_small.npz"))
    cfg = SiftConfig(dtype=dtype, extrema_cap=1024, kp_cap=512, ori_cap=2048)
    octaves = int(oracle["octaves_count"][0])
    st = detect_stages(oracle["input"], cfg, octaves, device="cpu")
    fin = st["final"]
    assert int(fin.valid.sum()) > 0
    desc = torch.zeros_like(fin.desc)
    for o in range(octaves):
        sp = StackSpace.build([st["gaussians"][o][None]])
        cand, _ = orient_all(sp, st["refined"][o].map(lambda a: a[None]), cfg,
                             octave_of_volume=(o,))
        cand = kputil.compact(cand.map(lambda a: a[0]), 2 * cfg.kp_cap_for_octave(o))
        for f in kputil.FIELDS:
            assert torch.equal(getattr(cand, f), getattr(st["oriented"][o], f)), (o, f)
        sel = fin.valid & (fin.octave == o)
        desc[sel] = compute_descriptors_all(sp, fin.map(lambda a: a[None]), cfg,
                                            octave_of_volume=(o,))[0][sel]
    assert torch.equal(desc[fin.valid], fin.desc[fin.valid])


# Volumes of every width the tables must take (1, 10, 63, 64, 65, 130, 755,
# and 1510: two block chunks at blk 128), single-row volumes among them.
TABLE_VOLS = [(1, 1, 1), (1, 1, 755), (2, 3, 10), (3, 2, 63), (1, 4, 64), (2, 2, 65),
              (1, 3, 130), (1, 2, 1510)]


@pytest.mark.parametrize("blk", [64, 128])
def test_one_launch_multi_rows_table_equals_jax(blk):
    """The one-launch path of build_multi_rows: kernel H's table, walked
    unit by unit as the kernel walks it (``walk_plain``) into a NaN-filled
    buffer, writes every row exactly once and gives the JAX package's
    build_multi_rows bases and rows; the port's build_multi_rows (the plain
    version on the CPU) gives the same.  Tolerance: none."""
    vols = [_vol(s, seed=20 + i) for i, s in enumerate(TABLE_VOLS)]
    mats = [torch.from_numpy(v.reshape(-1, v.shape[-1])) for v in vols]
    table = TR.rows_table(tuple(tuple(m.shape) for m in mats), blk)
    assert table.regions == TR.rows_table(tuple(tuple(v.shape) for v in vols), blk).regions
    out = torch.full((1, table.rows, 2 * blk), float("nan"))
    writes = TR.walk_plain(table, mats, out)
    assert (writes == 1).all()
    want = JG.build_multi_rows([jnp.asarray(v) for v in vols], blk)
    assert tuple(e.base for e in table.regions) == tuple(want.bases)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(want.rows))
    got = build_multi_rows([torch.from_numpy(v) for v in vols], blk)
    assert got.bases == tuple(want.bases) and got.nbs == tuple(want.nbs)
    assert torch.equal(got.rows, out[0])
    one = TR.rows_table((tuple(mats[2].shape),), blk).regions
    assert len(one) == 1 and one[0].base == 0 and one[0].ls == 0 and one[0].rpad == mats[2].shape[0]
