"""The port's front-twin route against the JAX package: the layout plan
(``_front_twin_plan``), the plain version of kernel F against the Pallas
kernel ``fused_octave_front_twin`` in interpret mode and against the JAX
route's own buffers (``_jit_front_twin_batch``), the gathers over the
layer-minor twin rows against ``gather_patches_multi``, and the route as a
whole against the port's other routes.

JAX's buffers are compared only at positions a layout's ``index`` gives for
in-image (s, y, x): its alignment gaps, pad rows and rows past H are
undefined.  The JAX front route's *results* are not a reference (its
descriptor test fails in the JAX package itself); results are held against
the port's other routes."""

from __future__ import annotations

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from sift_tpu import SiftConfig as JaxConfig
from sift_tpu.config import gaussian_half_kernel
from sift_tpu.models import sift as JS
from sift_tpu.ops import gather as JG
from sift_tpu.ops import pallas_pyramid as JP
from sift_tpu.ops.blur import gaussian_blur
from sift_tpu_torch import SiftConfig, detect_and_describe_batch, kernels
from sift_tpu_torch.models import sift as S
from sift_tpu_torch.ops.gather import (
    CubeRows,
    MultiRows,
    StackSpace,
    cube_rows_params,
    from_reference_space,
    gather_patches,
    twin_strided,
)
from sift_tpu_torch.ops.octave_front import (
    front_twin_strip,
    octave_front_plain,
    octave_front_twin,
    octave_front_twin_plain,
)
from sift_tpu_torch.utils.keypoints import FIELDS

torch.set_num_threads(2)
DATA = pathlib.Path(__file__).parent / "data"
CAPS = dict(extrema_cap=1024, kp_cap=512, ori_cap=2048)
JCFG = JaxConfig()
HKS = [gaussian_half_kernel(s) for s in JCFG.gaussian_kernels()[1:]]
THR = JCFG.extremum_threshold()
BLK, G_L0, G_NL = 64, 1, len(HKS) - 2


@pytest.mark.parametrize("hw", [(960, 1280), (7, 10), (480, 19328), (480, 19329), (33, 40000)])
def test_front_twin_strip_equals_jax(hw):
    """The strip fixes the layouts; 19328 is the last width the JAX kernel
    takes at the default sigmas, 19329 the first that falls back."""
    want = JP.front_twin_strip(hw, HKS, G_NL, BLK)
    assert front_twin_strip(hw, HKS, G_NL, BLK) == want
    assert (want is None) == (hw[1] > 19328)
    assert front_twin_strip(hw, HKS, G_NL, BLK, torch.float64) is None


def _no_fit(heights, strip_fn):
    """A strip function that sends octaves of these heights to the fallback."""
    return lambda shape, *a: None if shape[-2] in heights else strip_fn(shape, *a)


@pytest.mark.parametrize("h1,w1,octaves,fallback", [
    (960, 1280, 8, ()), (960, 1280, 8, (960, 120)), (128, 192, 5, ()), (300, 138, 5, (150,)),
])
def test_front_twin_plan_equals_jax(monkeypatch, h1, w1, octaves, fallback):
    """Every octave's (h, w, strip, fits, nbt, gbase), the gauss buffer's
    rows and the stored layers as _front_twin_plan gives them, with and
    without octaves forced to the fallback; g_total padded to whole
    8-unit tiles as _jit_front_twin_batch pads it."""
    monkeypatch.setattr(JP, "front_twin_strip", _no_fit(fallback, JP.front_twin_strip))
    plan, g_total, _, g_l0, g_nl, n, blk = JS._front_twin_plan(JCFG, octaves, h1, w1)
    got = S.front_twin_plan(SiftConfig(), octaves, h1, w1, _no_fit(fallback, front_twin_strip))
    assert list(got.octaves) == plan
    assert [o[3] for o in got.octaves] == [o[0] not in fallback for o in plan]
    u = min(8, *(p[2] for p in plan))
    assert (got.unit, got.g_total) == (u, -(-g_total // (8 * u)) * (8 * u))
    assert (got.g_l0, got.g_nl, got.blk) == (g_l0, g_nl, blk)
    assert got.pk_nbps == tuple(cube_rows_params(n, p[1])[2] for p in plan)


@pytest.mark.parametrize("h1,octaves", [(960, 8), (48, 4)])
def test_front_twin_plan_of_wide_frames_equals_jax(h1, octaves):
    """Initial images 20,480 columns wide (16 frames of 640 side by side,
    doubled), nothing forced: the plan is _front_twin_plan's, and octave 0,
    alone, does not fit kernel F: the entry point sends it through the
    fallback, at strip 128 with 931 packed blocks at 960 rows."""
    plan, g_total, _, _, _, n, _ = JS._front_twin_plan(JCFG, octaves, h1, 20480)
    got = S.front_twin_plan(SiftConfig(), octaves, h1, 20480)
    assert list(got.octaves) == plan
    assert [o[3] for o in got.octaves] == [False] + [True] * (octaves - 1)
    assert got.g_total == -(-g_total // (8 * got.unit)) * (8 * got.unit)
    assert got.pk_nbps == tuple(cube_rows_params(n, p[1])[2] for p in plan)
    if h1 == 960:
        assert (got.octaves[0][2], got.pk_nbps[0]) == (128, 931)


def test_front_twin_plan_at_the_bench_size():
    """1280x960 initial images, 8 octaves: the numbers the layouts have on
    the card (82464 twin rows per image, padded to whole 8-unit tiles)."""
    plan = S.front_twin_plan(SiftConfig(), 8, 960, 1280)
    assert [o[2] for o in plan.octaves] == [256, 256, 256, 128, 64, 32, 32, 32]
    assert all(o[3] for o in plan.octaves)
    assert (plan.unit, plan.g_total) == (8, 82496)


def _seed(hw, seed=4):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (2,) + hw).astype(np.float32)
    # Smoothed so that DoG extrema exist and are not razor-marginal.
    return np.array(gaussian_blur(jnp.asarray(base), 2.0))


def _one_octave_spaces(h, w, st, grows, pk, n=len(HKS)):
    """The two layouts of one octave at base 0 over the given buffers."""
    nbt = -(-w // BLK)
    stride, sw, nbp = cube_rows_params(n, w)
    ls = st.bit_length() - 1
    gmr = MultiRows(rows=grows, shapes=((n + 1, h, w),), blk=BLK, nbs=(nbt,),
                    bases=(-G_L0 * nbt * st,), shp=(ls,), nls=(G_NL,), l0=G_L0)
    dcr = CubeRows(rows=pk, shapes=((n, h, w),), nbps=(nbp,), bases=(0,), stride=stride,
                   sw=sw, lss=(ls,))
    return gmr, dcr


def _all_positions(bsz, layers, h, w):
    g = torch.meshgrid(torch.arange(bsz), torch.as_tensor(layers), torch.arange(h),
                       torch.arange(w), indexing="ij")
    return [a.reshape(-1) for a in g]


@pytest.mark.parametrize("hw", [(96, 160), (150, 69)])
def test_octave_front_twin_plain_against_pallas_kernel(hw):
    """Kernel F's plain version against fused_octave_front_twin in interpret
    mode, one octave.  At every indexed position (both twin blocks of each
    gauss value, every packed window a cube gather can take a DoG value
    from) the port's buffers hold the port's own plain stacks bit for bit,
    and JAX's buffers hold them within 1e-4 (the ulp contract of the Pallas
    front kernel's own test: JAX's float32 blur multiplies by a reciprocal
    where the port divides); ``down`` within 1e-4; mask and counts exact."""
    h, w = hw
    img = _seed(hw)
    st = JP.front_twin_strip(hw, HKS, G_NL, BLK)
    nbt, nstrips = -(-w // BLK), -(-h // st)
    nbp = cube_rows_params(len(HKS), w)[2]
    jg = jnp.full((2, nstrips * G_NL * nbt * st, 2 * BLK), -1.0, jnp.float32)
    jg, jpk, jm, jc, jdown = JP.fused_octave_front_twin(
        jnp.asarray(img), HKS, THR, jg, 0, st, BLK, G_L0, G_NL, interpret=True)

    grows = torch.zeros(tuple(jg.shape))
    pk = torch.zeros((2, nstrips * nbp * st, 128))
    seed = torch.from_numpy(img)
    before = kernels.launch_counts()["octave_front_twin"]
    m, c, down = octave_front_twin(seed, HKS, THR, grows, 0, st, BLK, G_L0, G_NL, pk, 0)
    # a CPU tensor: the plain version
    assert kernels.launch_counts()["octave_front_twin"] == before
    g, d, m0, c0 = octave_front_plain(seed, HKS, THR)
    assert torch.equal(m, m0) and torch.equal(c, c0) and torch.equal(down, g[:, len(HKS) - 2])

    gmr, dcr = _one_octave_spaces(h, w, st, grows, pk)
    jgf, jpf = np.asarray(jg).reshape(-1), np.asarray(jpk).reshape(-1)
    bi, s, y, x = _all_positions(2, range(G_L0, G_L0 + G_NL), h, w)
    zero = torch.zeros_like(bi)
    for x0 in (x, (x - BLK).clamp_min(0)):  # the value's own block, and the one before
        idx = gmr.index(bi, zero, s, y, x, x0)
        assert torch.equal(grows.reshape(-1)[idx], g[bi, s, y, x])
        np.testing.assert_allclose(jgf[idx.numpy()], g[bi, s, y, x].numpy(), rtol=0, atol=1e-4)
    bi, s, y, x = _all_positions(2, range(len(HKS)), h, w)
    zero = torch.zeros_like(bi)
    for back in (0, 1, 2):  # the window starts a cube gather reads column x from
        idx = dcr.index(bi, zero, s, y, x, (x - back).clamp_min(0))
        assert torch.equal(pk.reshape(-1)[idx], d[bi, s, y, x])
        np.testing.assert_allclose(jpf[idx.numpy()], d[bi, s, y, x].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(down.numpy(), np.asarray(jdown), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(m.numpy()[..., :w], np.asarray(jm))
    assert not m.numpy()[..., w:].any() and m.shape[-1] == -(-w // 128) * 128
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert int(c.sum()) > 0, "test image produced no extrema"


def test_octave_front_twin_refuses_buffers_that_do_not_fit():
    seed = torch.from_numpy(_seed((40, 69)))
    st, nbt, nbp = 32, 2, cube_rows_params(len(HKS), 69)[2]
    grows = torch.zeros((2, 3 * 2 * G_NL * nbt * st, 2 * BLK))
    pk = torch.zeros((2, 3 * 2 * nbp * st, 128))
    args = (seed, HKS, THR, grows, G_NL * nbt * st, st, BLK, G_L0, G_NL, pk, nbp * st)
    octave_front_twin_plain(*args)
    for bad in ({3: grows[:, :500].contiguous()}, {4: 5}, {9: pk[:1]}, {10: 5 * nbp * st}, {5: 24}):
        with pytest.raises(ValueError, match="octave_front_twin"):
            octave_front_twin_plain(*[bad.get(i, a) for i, a in enumerate(args)])


SHAPES = [(6, 40, 200), (6, 20, 100)]


def _layer_minor_spaces(l0, nl, st=16, seed=11):
    """A layer-minor MultiRows over two volumes built by the JAX package's
    twin_strided_xla (bases shifted by -l0 * nb * st as the route shifts
    them), the port's twin_strided of the same volumes, and the stacks."""
    rng = np.random.default_rng(seed)
    vols = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    rows, bases, prows, acc = [], [], [], 0
    for v in vols:
        nb = -(-v.shape[2] // BLK)
        t = JP.twin_strided_xla(jnp.asarray(v)[None], BLK, st, l0, nl)[0]
        prows.append(twin_strided(torch.from_numpy(v)[None], BLK, st, l0, nl)[0])
        bases.append(acc - l0 * nb * st)
        acc += t.shape[0]
        rows.append(t)
    jmr = JG.MultiRows(
        rows=jnp.concatenate(rows, 0), shapes=tuple(SHAPES), blk=BLK,
        nbs=tuple(-(-s[2] // BLK) for s in SHAPES), bases=tuple(bases),
        shp=(st.bit_length() - 1,) * 2, nls=(nl,) * 2)
    return jmr, torch.cat(prows), StackSpace.build([torch.from_numpy(v)[None] for v in vols])


@pytest.mark.parametrize("patch", [9, 33, 83])
@pytest.mark.parametrize("l0,nl", [(0, 6), (1, 3)], ids=["all_layers", "layers_1_to_3"])
def test_patch_gathers_over_layer_minor_rows(l0, nl, patch):
    """twin_strided == twin_strided_xla, and gather_patches over the
    layer-minor MultiRows (converted from the JAX space, so over the very
    same buffer) == the port's StackSpace everywhere == the JAX package's
    gather_patches_multi, per row and through its u-row units (rows_u), on
    the columns inside the image; windows of 9, 33 and 83 columns, some
    hanging off the right edge.  Tolerance: none."""
    jmr, prows, sp = _layer_minor_spaces(l0, nl)
    np.testing.assert_array_equal(prows.numpy(), np.asarray(jmr.rows))
    jmu = JG.with_row_units(jmr)
    mr = from_reference_space(jmu, l0=l0)
    assert mr.unit == 8 and tuple(mr.rows_u.shape) == tuple(jmu.rows_u.shape)
    np.testing.assert_array_equal(mr.rows_u.numpy(), np.asarray(jmu.rows_u))
    rng = np.random.default_rng(12)
    n = 150
    oct_id = rng.integers(0, 2, n)
    hs = np.array([SHAPES[o][1] for o in oct_id])
    ws = np.array([SHAPES[o][2] for o in oct_id])
    layer = rng.integers(l0, l0 + nl, n)
    ys0 = rng.integers(-5, 70, n) % (hs + 10) - 5
    xs0 = rng.integers(-5, 210, n) % (ws + 10) - 5
    xs0[:20] = ws[:20] - rng.integers(1, patch, 20)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))  # noqa: E731
    args = (torch.zeros(n, dtype=torch.int64), t(oct_id), t(layer), t(ys0), t(xs0), patch)
    got = gather_patches(mr, *args)
    assert torch.equal(got, gather_patches(sp, *args))
    cols = xs0[:, None] + np.arange(patch)[None, :]
    inside = np.broadcast_to(((cols >= 0) & (cols < ws[:, None]))[:, None, :], tuple(got.shape))
    jargs = [jnp.asarray(a, jnp.int32) for a in (oct_id, layer, ys0, xs0)]
    for space in (jmr, jmu):
        want = np.asarray(JG.gather_patches_multi(space, *jargs, patch))
        np.testing.assert_array_equal(got.numpy()[inside], want[inside])


def test_layers_outside_the_stored_range_are_clamped():
    """A layer-minor space that stores layers [1, 3] answers a lane whose
    layer is 0 or S - 1 (only lanes whose values are never used hold one)
    with the nearest stored layer's element: no index leaves the buffer."""
    jmr, _, _ = _layer_minor_spaces(1, 3)
    mr = from_reference_space(jmr, l0=1)
    z = torch.zeros(4, dtype=torch.int64)
    y, x = z + 7, z + 130
    got = mr.index(z, z, torch.tensor([0, 1, 3, 5]), y, x, x)
    assert got[0] == got[1] and got[3] == got[2]
    assert 0 <= int(got.min()) and int(got.max()) < mr.flat.numel()


@pytest.fixture(scope="module")
def small_batch():
    small = dict(np.load(DATA / "oracle_small.npz"))["input"].astype(np.float32)
    return np.stack([small, small[:, ::-1]])


def test_front_twin_buffers_against_the_jax_route(small_batch):
    """front_twin against _jit_front_twin_batch (its Pallas kernels in
    interpret mode) on a 64x96 pair, 5 octaves: the same layouts (every
    static field, the buffers' shapes), and at every indexed position of
    every octave the port's buffers hold the port's own plain pyramid bit
    for bit and JAX's hold it within 1e-3 (the 1e-4 of one octave, carried
    through five seeds); true extrema counts per octave equal."""
    cfg = SiftConfig(**CAPS)
    imgs = S.as_batch(small_batch, cfg, "cpu")
    octaves = S.octaves_for(imgs, cfg)
    jcfg = JaxConfig(dtype=jnp.float32, use_pallas_pyramid=True, **CAPS)
    jg, jd, jmasks, jcounts = JS._jit_front_twin_batch(jnp.asarray(small_batch), jcfg, octaves)
    gmr, dcr, masks, counts = S.front_twin(imgs, cfg)
    assert (gmr.shapes, gmr.blk, gmr.nbs, gmr.bases, gmr.shp, gmr.nls, gmr.unit) == (
        jg.shapes, jg.blk, jg.nbs, jg.bases, jg.shp, jg.nls, jg.unit)
    assert tuple(gmr.rows_u.reshape(-1, gmr.rows_u.shape[-1]).shape) == tuple(jg.rows_u.shape)
    assert (dcr.shapes, dcr.nbps, dcr.bases, dcr.stride, dcr.sw, dcr.lss) == (
        jd.shapes, jd.nbps, jd.bases, jd.stride, jd.sw, jd.lss)
    assert tuple(dcr.rows.shape) == tuple(jd.rows.shape)
    jgs = from_reference_space(jg, batch=2, l0=G_L0)
    jds = from_reference_space(jd)
    gaussians, dogs, masks0, counts0 = S.front(imgs, cfg)
    for o in range(octaves):
        assert torch.equal(masks[o], masks0[o]) and torch.equal(counts[o], counts0[o])
        np.testing.assert_array_equal(counts[o].sum((1, 2, 3)).numpy(),
                                      np.asarray(jcounts[o]).sum((1, 2, 3)))
        assert tuple(masks[o].shape) == tuple(jmasks[o].shape)
        _, h, w = gmr.shapes[o]
        bi, s, y, x = _all_positions(2, range(G_L0, G_L0 + G_NL), h, w)
        oc = torch.full_like(bi, o)
        want = gaussians[o][bi, s, y, x]
        assert torch.equal(gmr.flat[gmr.index(bi, oc, s, y, x, x)], want)
        np.testing.assert_allclose(jgs.flat[jgs.index(bi, oc, s, y, x, x)].numpy(), want.numpy(),
                                   rtol=0, atol=1e-3)
        bi, s, y, x = _all_positions(2, range(len(HKS)), h, w)
        oc = torch.full_like(bi, o)
        want = dogs[o][bi, s, y, x]
        x0 = (x - 1).clamp_min(0)
        assert torch.equal(dcr.flat[dcr.index(bi, oc, s, y, x, x0)], want)
        np.testing.assert_allclose(jds.flat[jds.index(bi, oc, s, y, x, x0)].numpy(), want.numpy(),
                                   rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def wide_rows():
    """Rows 0-23 of chip_smoke.py's two wide frames: CAVE-01 scene frames
    00-15 and 01-16, each set side by side (24 x 10,240, doubled to 48 x
    20,480)."""
    return chip_smoke.wide_frames(24)


WIDE_CAPS = dict(extrema_cap=8192, kp_cap=2048, ori_cap=4096)


@pytest.mark.parametrize("fallback", [(), (64,), (128, 16), "wide"],
                         ids=["fused", "one", "two", "wide"])
def test_front_twin_route_equals_the_other_routes(small_batch, wide_rows, fallback):
    """float32 through the knob on the CPU: the entry point takes the
    front-twin route, and its final buffer and counts are, bit for bit, the
    front route's and the plain-stack route's; the same with octaves forced
    through the fallback (kernel A's values, twin_strided, kernel G's
    rows), and ("wide") with the fallback the entry point takes on its own
    for an octave wider than 19,328 columns (the wide frames' octave 0;
    capacities that clip nothing).  Tolerance: none."""
    wide = fallback == "wide"
    cfg = SiftConfig(use_octave_kernel=True, **(WIDE_CAPS if wide else CAPS))
    assert S.route_of(cfg, "cpu") == "front_twin"
    frames = wide_rows if wide else small_batch
    imgs = S.as_batch(frames, cfg, "cpu")
    plan = None
    if wide:
        natural = S.front_twin_plan(cfg, S.octaves_for(imgs, cfg), 48, 20480)
        assert [o[3] for o in natural.octaves] == [False, True, True, True]
    elif fallback:
        plan = S.front_twin_plan(cfg, S.octaves_for(imgs, cfg), 128, 192,
                                 _no_fit(fallback, front_twin_strip))
        assert [o[3] for o in plan.octaves].count(False) == len(fallback)
    got, counts = S.run_route(imgs, cfg, "front_twin", plan)
    assert int(got.valid.sum()) > 0
    if wide:
        assert int(counts["extrema"].max()) <= cfg.extrema_cap
        assert int(counts["refined"].max()) <= cfg.kp_cap
        assert int(counts["oriented"].max()) <= cfg.ori_cap
    if plan is None:
        entry = detect_and_describe_batch(frames, cfg, device="cpu")
        for f in FIELDS:
            assert torch.equal(getattr(entry, f), getattr(got, f)), f
    for route in ("front", "stacks"):
        want, wcounts = S.run_route(imgs, dataclasses.replace(cfg, use_octave_kernel=None), route)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (route, f)
        for k in counts:
            assert torch.equal(torch.as_tensor(counts[k]), torch.as_tensor(wcounts[k])), (route, k)


def test_wide_fallback_buffers_equal_kernel_f_at_its_strip(wide_rows):
    """The wide frames' octave 0 through the fallback (kernel A's values,
    twin_strided, kernel G's rows) fills both gather buffers exactly as
    kernel F does with the same plan forced to fit at strip 128 (the same
    layout: F tiles columns, so width is no limit to it); plain versions
    here, the kernels on the card in chip_smoke.py.  Tolerance: none."""
    cfg = SiftConfig(use_octave_kernel=True, **WIDE_CAPS)
    imgs = S.as_batch(wide_rows, cfg, "cpu")
    natural = S.front_twin_plan(cfg, 4, 48, 20480)
    fused = S.front_twin_plan(
        cfg, 4, 48, 20480,
        lambda shape, *a: natural.octaves[0][2] if tuple(shape) == (48, 20480)
        else front_twin_strip(shape, *a))
    assert [o[3] for o in fused.octaves] == [True] * 4
    assert [o[:3] + o[4:] for o in fused.octaves] == [o[:3] + o[4:] for o in natural.octaves]
    assert (fused.g_total, fused.pk_bases, fused.pk_total) == (
        natural.g_total, natural.pk_bases, natural.pk_total)
    g_a, d_a, m_a, c_a = S.front_twin(imgs, cfg, natural)
    g_f, d_f, m_f, c_f = S.front_twin(imgs, cfg, fused)
    assert torch.equal(g_a.rows, g_f.rows) and torch.equal(d_a.rows, d_f.rows)
    for a, b in zip(m_a + c_a, m_f + c_f):
        assert torch.equal(a, b)


def test_wide_fallback_buffers_against_the_jax_fallback(wide_rows):
    """The entry point's natural route on the wide crop (octave 0 through
    the fallback on its own) against the JAX package's fallback on the same
    frames: its initial image, then per octave ``octave_front_xla``,
    ``twin_strided_xla`` and the plain reference of its Pallas
    ``cube_pack_rows`` (``cube_rows_xla``, bit-equal to it on in-image rows;
    the Pallas kernel itself is held against it at 9 x 20,480 in
    test_torch_cube_rows.py), written at the bases of JAX's own plan, and
    ``downsample_nearest_x2_mxu`` for the next seed.  JAX's route takes that
    fallback for octave 0 and documents it as the same layout as its kernel
    for the others.  Run op by op (not jitted: XLA's fusions round
    differently), the JAX functions do the port's float32 operations in the
    port's order, so at every indexed position of every octave both gather
    buffers, and every mask and count, are equal.  Tolerance: none."""
    from sift_tpu.models.detect import octave_front_xla
    from sift_tpu.models.pyramid import compute_initial_image as j_initial
    from sift_tpu.ops.pallas_pyramid import twin_strided_xla
    from sift_tpu.ops.resize import downsample_nearest_x2_mxu

    cfg = SiftConfig(use_octave_kernel=True, **WIDE_CAPS)
    imgs = S.as_batch(wide_rows, cfg, "cpu")
    octaves = S.octaves_for(imgs, cfg)
    gmr, dcr, masks, counts = S.front_twin(imgs, cfg)
    jcfg = JaxConfig(dtype=jnp.float32, **WIDE_CAPS)
    plan, _, hks, g_l0, g_nl, _, blk = JS._front_twin_plan(jcfg, octaves, 48, 20480)
    assert [p[3] for p in plan] == [False, True, True, True]
    assert (g_l0, g_nl, blk) == (G_L0, G_NL, BLK)
    jgrows = np.zeros(tuple(gmr.rows.shape), np.float32)
    jpk = np.zeros(tuple(dcr.rows.shape), np.float32)
    img = j_initial(jnp.asarray(wide_rows.astype(np.float32)), jcfg)
    for o, ((h, w, st, _, _, gbase), pkbase) in enumerate(zip(plan, dcr.bases)):
        g, d, m, c = octave_front_xla(img, hks, jcfg.extremum_threshold(), jcfg.window_size)
        gt = np.asarray(twin_strided_xla(g, blk, st, g_l0, g_nl))
        jgrows[:, gbase: gbase + gt.shape[1]] = gt
        pk = np.asarray(JG.cube_rows_xla(d, st))
        jpk[:, pkbase: pkbase + pk.shape[1]] = pk
        np.testing.assert_array_equal(masks[o][..., :w].numpy(), np.asarray(m)[..., :w])
        np.testing.assert_array_equal(counts[o].numpy(), np.asarray(c))
        img = downsample_nearest_x2_mxu(g[:, g.shape[1] - 3])
    jg = dataclasses.replace(gmr, rows=torch.from_numpy(jgrows))
    jd = dataclasses.replace(dcr, rows=torch.from_numpy(jpk))
    for o in range(octaves):
        _, h, w = gmr.shapes[o]
        bi, s, y, x = _all_positions(2, range(G_L0, G_L0 + G_NL), h, w)
        oc = torch.full_like(bi, o)
        at = gmr.index(bi, oc, s, y, x, x)
        assert torch.equal(gmr.flat[at], jg.flat[at]), o
        bi, s, y, x = _all_positions(2, range(len(HKS)), h, w)
        oc = torch.full_like(bi, o)
        at = dcr.index(bi, oc, s, y, x, (x - 1).clamp_min(0))
        assert torch.equal(dcr.flat[at], jd.flat[at]), o
