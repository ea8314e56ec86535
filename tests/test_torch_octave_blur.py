"""The port's octave blur (the plain version of kernel C) and its
``build_pyramids`` against the JAX package: ``ops/pallas_pyramid.
fused_octave_blur`` in interpret mode and ``models/pyramid.build_pyramids``
on its XLA chain."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu import SiftConfig as JaxConfig
from sift_tpu.models.pyramid import build_pyramids as jax_build_pyramids
from sift_tpu.ops.pallas_pyramid import fused_octave_blur
from sift_tpu_torch import SiftConfig, kernels
from sift_tpu_torch.models.pyramid import blur_half_kernels, build_pyramids, front_pyramids
from sift_tpu_torch.ops.octave_blur import octave_blur, octave_blur_plain

torch.set_num_threads(2)
HKS = blur_half_kernels(SiftConfig())


def as_lists(gauss: torch.Tensor, dogs: torch.Tensor):
    """The JAX ``fused_octave_blur`` lists from the stacks: ``gauss[i]`` is
    blur i+1 (the seed left out) and ``dogs[i] = gauss[i] - gauss[i-1]``."""
    return list(gauss.unbind(-3)[1:]), list(dogs.unbind(-3))


@pytest.mark.parametrize("shape", [(2, 96, 128), (2, 67, 257), (48, 160)],
                         ids=["96x128", "67x257", "2d"])
def test_octave_blur_matches_pallas_interpret(shape):
    """Tolerance: gauss within atol 1e-4 of the Pallas kernel in float32
    (its own contract, tests/test_pallas_pyramid.py); each DoG exactly
    gauss[i+1] - gauss[i] (none), and within 2e-4 of the kernel's (the sum
    of two gauss tolerances)."""
    img = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    jg, jd = fused_octave_blur(jnp.asarray(img), HKS, interpret=True)
    g, d = octave_blur_plain(torch.from_numpy(img), HKS)
    assert g.shape[-3:] == (6,) + shape[-2:] and d.shape[-3:] == (5,) + shape[-2:]
    np.testing.assert_array_equal(g.select(-3, 0).numpy(), img)
    tg, td = as_lists(g, d)
    assert len(tg) == len(td) == len(jg) == 5
    prev = g.select(-3, 0)
    for i in range(5):
        np.testing.assert_allclose(tg[i].numpy(), np.asarray(jg[i]), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(td[i].numpy(), (tg[i] - prev).numpy())
        np.testing.assert_allclose(td[i].numpy(), np.asarray(jd[i]), rtol=0, atol=2e-4)
        prev = tg[i]


@pytest.fixture(scope="module")
def initial64():
    """A float64 (2, 80, 112) initial image (4 octaves)."""
    img = np.random.default_rng(3).uniform(0, 255, (2, 80, 112)).astype(np.float64)
    return torch.from_numpy(img)


def test_build_pyramids_bit_equal_to_jax_xla_chain(initial64):
    """Tolerance: none (float64 bits), every gauss and DoG layer of every
    octave, against JAX's build_pyramids with use_pallas_pyramid=False."""
    cfg = SiftConfig(dtype=torch.float64)
    jcfg = JaxConfig(dtype=jnp.float64, use_pallas_pyramid=False)
    octaves = cfg.octaves_count(112, 80)
    jg, jd = jax_build_pyramids(jnp.asarray(initial64.numpy()), jcfg, octaves)
    tg, td = build_pyramids(initial64, cfg, octaves)
    assert len(tg) == len(td) == len(jg) == octaves
    for o in range(octaves):
        assert tg[o].shape == jg[o].shape and td[o].shape == jd[o].shape
        np.testing.assert_array_equal(tg[o].numpy(), np.asarray(jg[o]), err_msg=f"gauss {o}")
        np.testing.assert_array_equal(td[o].numpy(), np.asarray(jd[o]), err_msg=f"dog {o}")


@pytest.mark.parametrize("knob", [None, True, False])
def test_build_pyramids_equals_front_pyramids(initial64, knob):
    """The octave kernel's route, the blur chain and the front route build
    the same pyramid.  Tolerance: none."""
    cfg = SiftConfig(dtype=torch.float32, use_octave_kernel=knob)
    init = initial64.float()
    octaves = cfg.octaves_count(112, 80)
    bg, bd = build_pyramids(init, cfg, octaves)
    fg, fd, _, _ = front_pyramids(init, cfg, octaves)
    for o in range(octaves):
        assert torch.equal(bg[o], fg[o]) and torch.equal(bd[o], fd[o]), o


def test_octave_blur_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor kernel C's wrapper is the plain version and counts
    no launch."""
    seed = torch.from_numpy(np.random.default_rng(4).uniform(0, 255, (2, 30, 50)).astype(np.float32))
    before = kernels.launch_counts()["octave_blur"]
    for a, b in zip(octave_blur(seed, HKS), octave_blur_plain(seed, HKS)):
        assert torch.equal(a, b)
    assert kernels.launch_counts()["octave_blur"] == before
    with pytest.raises(ValueError, match="unsupported device"):
        octave_blur(seed.to("meta"), HKS)

