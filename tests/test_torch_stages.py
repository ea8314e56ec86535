"""The port's staged path ``detect_stages`` on the CPU in float64, held to
the C++ reference's stage dumps (tests/data/oracle_*.npz) as the JAX
package's tests/test_parity_stages.py holds its own, and on the small
frame lane for lane to the JAX package's ``detect_stages``."""

from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu import SiftConfig as JaxConfig
from sift_tpu.models.sift import detect_stages as jax_detect_stages
from sift_tpu_torch import SiftConfig, detect_and_describe_batch
from sift_tpu_torch.models.sift import as_batch, detect_stages, octaves_for

torch.set_num_threads(2)
DATA = pathlib.Path(__file__).parent / "data"
CAPS = dict(extrema_cap=1024, kp_cap=512, ori_cap=2048)
CFG = SiftConfig(dtype=torch.float64, **CAPS)


@pytest.fixture(scope="module", params=["small", "medium"])
def case(request):
    oracle = dict(np.load(DATA / f"oracle_{request.param}.npz"))
    octaves = int(oracle["octaves_count"][0])
    return oracle, detect_stages(oracle["input"], CFG, octaves, device="cpu")


def test_pyramid_bit_equal(case):
    """initial, gauss.*, dog.*: tolerance none (float64 bits)."""
    oracle, st = case
    np.testing.assert_array_equal(st["initial"].numpy(), oracle["initial"])
    assert len(st["gaussians"]) == int(oracle["octaves_count"][0])
    for o, (g, d) in enumerate(zip(st["gaussians"], st["dogs"])):
        for i in range(g.shape[0]):
            np.testing.assert_array_equal(g[i].numpy(), oracle[f"gauss.{o}.{i}"])
        for i in range(d.shape[0]):
            np.testing.assert_array_equal(d[i].numpy(), oracle[f"dog.{o}.{i}"])


def test_extrema_exact(case):
    """Oracle rows are (x, y, layer, octave) (src/sift.cpp:284)."""
    oracle, st = case
    mine = set()
    for o, (zyx, valid) in enumerate(st["extrema"]):
        mine |= {(x, y, z, o) for z, y, x in zyx[valid].tolist()}
    assert mine == {tuple(r) for r in oracle["extrema"].tolist()}


def _lanes(kp, fields):
    v = kp.valid.numpy()
    cols = [getattr(kp, f).numpy()[v] for f in fields]
    return {tuple(float(c[i]) for c in cols) for i in range(int(v.sum()))}


def _oracle(oracle, prefix, fields):
    cols = [oracle[f"{prefix}.{f}"] for f in fields]
    return {tuple(float(c[i]) for c in cols) for i in range(len(cols[0]))}


def test_refined_exact(case):
    """x, y, size, octave, layer: tolerance none."""
    oracle, st = case
    fields = ("x", "y", "size", "octave", "layer")
    mine = set().union(*(_lanes(kp, fields) for kp in st["refined"]))
    assert mine == _oracle(oracle, "refined", fields)


def test_oriented_exact(case):
    """x, y, size, octave, layer exact; pori rounded to 1e-9 (libm's exp /
    atan2 differ from glibc's in the last ulp; test_parity_stages's
    contract)."""
    oracle, st = case
    fields = ("x", "y", "size", "pori", "octave", "layer")

    def rnd(s):
        return {(x, y, sz, round(p, 9), o, la) for x, y, sz, p, o, la in s}

    mine = set().union(*(rnd(_lanes(kp, fields)) for kp in st["oriented"]))
    assert mine == rnd(_oracle(oracle, "oriented", fields))


def test_final_zero_descriptor_bytes_off(case):
    """Same final keypoint set (pori to 1e-9) and 0 descriptor bytes off."""
    oracle, st = case
    f = st["final"]
    v = f.valid.numpy()

    def keyed(x, y, size, pori, desc):
        return {(float(a), float(b), float(c), round(float(d), 9)): e
                for a, b, c, d, e in zip(x, y, size, pori, desc)}

    mine = keyed(*(getattr(f, k).numpy()[v] for k in ("x", "y", "size", "pori", "desc")))
    want = keyed(*(oracle[f"final.{k}"] for k in ("x", "y", "size", "pori", "desc")))
    assert set(mine) == set(want) and len(want) > 0
    assert sum(int(np.sum(mine[k] != want[k])) for k in want) == 0


def test_counts_within_capacities(case):
    """The true per-octave counts the staged path reports fit its
    per-octave capacities, and match the buffers."""
    _, st = case
    c = st["counts"]
    for o, kp in enumerate(st["refined"]):
        assert int(c["extrema"][o]) <= CFG.extrema_cap_for_octave(o)
        assert int(c["extrema"][o]) == int(st["extrema"][o][1].sum())
        assert int(c["refined"][o]) == int(kp.valid.sum()) <= CFG.kp_cap_for_octave(o)
        assert int(c["oriented"][o]) == int(st["oriented"][o].valid.sum())
        assert int(c["ori_slots_max"][o]) <= CFG.ori_cand_slots
    assert int(c["final"]) == int(st["final"].valid.sum()) <= CFG.ori_cap


def test_small_lane_for_lane_equals_jax_detect_stages():
    """Against the JAX package's detect_stages on the small frame, float64:
    every per-octave buffer lane for lane (valid masks equal; x, y, size,
    octave, layer and descriptors exact on valid lanes; pori within 1e-9,
    the libm contract above)."""
    oracle = dict(np.load(DATA / "oracle_small.npz"))
    octaves = int(oracle["octaves_count"][0])
    st = detect_stages(oracle["input"], CFG, octaves, device="cpu")
    js = jax_detect_stages(jnp.asarray(oracle["input"].astype(np.float64)),
                           JaxConfig(dtype=jnp.float64, **CAPS), octaves)
    for o in range(octaves):
        (tz, tv), (jz, jv) = st["extrema"][o], js["extrema"][o]
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tz.numpy()[tv.numpy()], np.asarray(jz)[np.asarray(jv)])
    pairs = [(a, b) for k in ("refined", "oriented") for a, b in zip(st[k], js[k])]
    pairs.append((st["final"], js["final"]))
    for t, j in pairs:
        v = t.valid.numpy()
        np.testing.assert_array_equal(v, np.asarray(j.valid))
        for f in ("x", "y", "size", "octave", "layer", "desc"):
            np.testing.assert_array_equal(getattr(t, f).numpy()[v], np.asarray(getattr(j, f))[v],
                                          err_msg=f)
        np.testing.assert_allclose(t.pori.numpy()[v], np.asarray(j.pori)[v], rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", ["small", "medium"])
def test_float32_staged_equals_batch_route(name):
    """In float32 the staged path's final valid lanes (x, y, size, pori,
    octave, layer, desc) equal the batch route's for the same frame, in
    the same order: the same pyramid, the same per-lane math and the same
    relative lane order before dedup.  Tolerance: none."""
    img = dict(np.load(DATA / f"oracle_{name}.npz"))["input"]
    cfg = SiftConfig(**CAPS)
    kp = detect_and_describe_batch(img[None], cfg, device="cpu").map(lambda a: a[0])
    st = detect_stages(img, cfg, octaves_for(as_batch(img[None], cfg, "cpu"), cfg), device="cpu")
    fin = st["final"]
    assert int(fin.valid.sum()) == int(kp.valid.sum()) > 0
    for f in ("x", "y", "size", "pori", "octave", "layer", "desc"):
        assert torch.equal(getattr(fin, f)[fin.valid], getattr(kp, f)[kp.valid]), f
