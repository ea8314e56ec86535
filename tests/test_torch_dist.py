"""The port's ``parallel/dist.py`` and ``models/sift.detect_fn`` against the
JAX package on the CPU: ``sharded_match`` on gloo ranks against the JAX
``sharded_match`` on its simulated mesh (bit for bit, kp = 2 and 4, shard
widths that are not 128, ties across shard borders, invalid columns),
``batched_detect`` (data = 2) against the port's ``detect_fn`` image by
image, and ``detect_fn`` against the JAX ``detect_fn`` in float64.  The
rank pool is spawned once for the file."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu import SiftConfig as JaxConfig
from sift_tpu.models.sift import detect_fn as jax_detect_fn
from sift_tpu.parallel.dist import sharded_match as jax_sharded_match
from sift_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.models.match import match_descriptors
from sift_tpu_torch.models.sift import detect_fn
from sift_tpu_torch.parallel.dist import batched_detect, sharded_match
from sift_tpu_torch.parallel.multihost import MeshSpec, Step, run_steps
from sift_tpu_torch.utils.keypoints import FIELDS

DATA = "tests/data"
RANKS = 4


def planted():
    """200 x 480 with ties planted across the kp = 2 and kp = 4 shard
    borders (120, 240, 360) and invalid columns, one of them a duplicate."""
    rng = np.random.default_rng(42)
    d1 = rng.integers(0, 256, (200, 128), dtype=np.uint8)
    d2 = rng.integers(0, 256, (480, 128), dtype=np.uint8)
    for k, (a, b) in enumerate([(119, 120), (239, 240), (359, 360), (10, 470)]):
        d2[a] = d2[b] = d1[k]
    d2[300] = d1[4]  # the duplicate of a best
    d2[301] = d1[4]
    v2 = rng.random(480) > 0.1
    v2[[119, 239, 240, 359, 360, 10, 470, 301]] = True
    v2[[300, 120, 5]] = False
    d2[5] = d1[5]    # an exact copy that is invalid
    return d1, np.ones(200, bool), d2, v2


def spread():
    """test_match.py's winners in every shard: 256 x 384 (widths 192, 96)."""
    rng = np.random.default_rng(7)
    n, m = 256, 384
    d1 = rng.integers(0, 256, (n, 128)).astype(np.uint8)
    d2 = rng.integers(0, 256, (m, 128)).astype(np.uint8)
    for i in range(0, n, 5):
        d2[(i * 3 + 11) % m] = np.clip(d1[i].astype(int) + rng.integers(-2, 3, 128),
                                       0, 255).astype(np.uint8)
    return d1, np.ones(n, bool), d2, np.ones(m, bool)


def frames():
    """96 x 128 crops of CAVE 00-03 at a quarter of their size."""
    return np.stack([np.load(f"{DATA}/oracle_cave0{i}.npz")["input"][::4, ::4][:96, :128]
                     for i in range(4)]).astype(np.float32)


CFG = SiftConfig(extrema_cap=1024, kp_cap=512, ori_cap=1024)
OCTAVES = CFG.octaves_count(256, 192)
CASES = {"planted": planted, "spread": spread}
MESHES = {"1x2": MeshSpec(1, 2, ranks=(0, 1)), "1x4": MeshSpec(1, 4), "2x2": MeshSpec(2, 2)}


@pytest.fixture(scope="module")
def ranks():
    """One spawn: every case on every mesh, then batched_detect."""
    steps, where = [], {}
    for case, make in CASES.items():
        for name, spec in MESHES.items():
            where[case, name] = len(steps)
            steps.append(Step(sharded_match, (*make(), spec)))
    d1, v1, d2, v2 = planted()
    where["pairs"] = len(steps)  # two pairs in one call
    steps.append(Step(sharded_match, (np.stack([d1, d1[::-1]]), np.stack([v1, v1]),
                                      np.stack([d2, d2]), np.stack([v2, ~v2]), MeshSpec(1, 4))))
    where["detect"] = len(steps)
    steps.append(Step(batched_detect, (frames(), CFG, OCTAVES, MeshSpec(2, 2))))
    return where, run_steps(steps, RANKS)


@functools.cache
def jax_match(case: str, kp: int):
    """The JAX sharded_match on its simulated mesh (jitted: its eager
    shard_map dispatch takes seconds a call on the CPU)."""
    fn = jax.jit(functools.partial(jax_sharded_match, mesh=jax_make_mesh(data=1, kp=kp)))
    return [np.asarray(a) for a in fn(*CASES[case]())]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_match_equals_jax_sharded_match(ranks, case, mesh):
    """Bit for bit against the JAX function on the same kp width: best,
    second, accept and the index (also where not accepted), on every rank
    of the mesh; kp = 2 also on a mesh of two of the four ranks."""
    where, res = ranks
    spec = MESHES[mesh]
    want = jax_match(case, spec.kp)
    members = spec.ranks or range(RANKS)
    assert [r for r in range(RANKS) if res[r][where[case, mesh]] is not None] == list(members)
    for r in members:
        idx, acc, best, second = (a.numpy() for a in res[r][where[case, mesh]].out)
        np.testing.assert_array_equal(acc, want[1])
        np.testing.assert_array_equal(best, want[2])
        np.testing.assert_array_equal(second, want[3])
        np.testing.assert_array_equal(idx, want[0])


def test_sharded_match_equals_match_descriptors_and_plants_hold(ranks):
    """The single-process matcher gives the same bits; the planted ties
    resolve to the first index, and an invalid duplicate never wins."""
    where, res = ranks
    d1, v1, d2, v2 = planted()
    ref = match_descriptors(d1, v1, d2, v2, device="cpu")
    got = res[0][where["planted", "1x4"]].out
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    idx = got[0].numpy()
    assert list(idx[:4]) == [119, 239, 359, 10]
    assert idx[4] == 301 and idx[5] != 5


def test_sharded_match_batched_pairs(ranks):
    """(P, N, 128) inputs: each pair as the single-process matcher."""
    where, res = ranks
    d1, v1, d2, v2 = planted()
    out = res[2][where["pairs"]].out
    for p, (a1, b2, w2) in enumerate([(d1, d2, v2), (d1[::-1].copy(), d2, ~v2)]):
        ref = match_descriptors(a1, v1, b2, w2, device="cpu")
        for a, b in zip(out, ref):
            assert torch.equal(a[p], b)


def test_batched_detect_equals_detect_fn(ranks):
    """data = 2 (two kp ranks per share): every rank holds the whole
    batch, bit for bit the port's detect_fn image by image."""
    where, res = ranks
    imgs = frames()
    singles = [detect_fn(im, CFG, OCTAVES, device="cpu") for im in imgs]
    assert all(int(s.valid.sum()) > 10 for s in singles)
    for r in range(RANKS):
        kp = res[r][where["detect"]].out
        assert kp.x.shape == (4, CFG.ori_cap)
        for b, single in enumerate(singles):
            v = single.valid
            assert torch.equal(kp.valid[b], v)
            for f in FIELDS:
                if f != "valid":
                    assert torch.equal(getattr(kp, f)[b][v], getattr(single, f)[v]), f


def test_detect_fn_equals_jax_detect_fn_float64():
    """96 x 128 crop of CAVE 00 in float64: the same valid lanes, x, y,
    size and pori within 1e-9, every descriptor byte equal.  The port's
    float64 sizes take the host's pow (models/sift.host_exact_sizes), the
    JAX function XLA's: the largest size difference is asserted below."""
    img = np.load(f"{DATA}/oracle_cave00.npz")["input"][::5, ::5][:96, :128].astype(np.float64)
    cfg = SiftConfig(extrema_cap=1024, kp_cap=512, ori_cap=1024, dtype=torch.float64)
    octaves = cfg.octaves_count(256, 192)
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)} - {"dtype"}
    jcfg = JaxConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in jax_fields},
                     dtype=jnp.float64, use_pallas_pyramid=False, use_pallas_blur=False)
    want = jax.jit(lambda x: jax_detect_fn(x, jcfg, octaves))(jnp.asarray(img))
    got = detect_fn(img, cfg, octaves, device="cpu")
    v = np.asarray(want.valid)
    assert v.sum() > 30
    np.testing.assert_array_equal(got.valid.numpy(), v)
    for f in ("x", "y", "size", "pori"):
        np.testing.assert_allclose(getattr(got, f).numpy()[v], np.asarray(getattr(want, f))[v],
                                   rtol=0, atol=1e-9, err_msg=f)
    for f in ("octave", "layer", "desc"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[v],
                                      np.asarray(getattr(want, f))[v], err_msg=f)
    size_diff = np.abs(got.size.numpy()[v] - np.asarray(want.size)[v]).max()
    assert size_diff <= 4 * np.spacing(np.asarray(want.size)[v].max())
