"""The port's STITCH-GRAPH parser (``utils/stitch_graph``) and the 2D
convolution helpers (``ops/conv``) against the JAX package's.

The graph file is written by the test in the reference's pipe format.
Tolerances: the graph fields are compared exactly; ``apply_convolution`` in
float64 within 1e-12 (the two convolutions sum the taps in their own
orders), ``gaussian_kernel_2d`` and ``subtract`` exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sift_tpu.ops import conv as jax_conv
from sift_tpu.utils import stitch_graph as jax_graph
from sift_tpu_torch.ops import conv
from sift_tpu_torch.utils import stitch_graph

GRAPH_TEXT = """\
{ center_image_index | 1 | the scene's reference frame }
{ center_image_rotation_angle | 0.125 | radians }
{ images_count | 6 | declared frames }
{ matching_graph_image_edges-0 | 1,4 | }
{ matching_graph_image_edges-1 | 2 | }
{ matching_graph_image_edges-2 | 3,5 | }
{ matching_graph_image_edges-4 | 3 | }
not a field line
{ malformed }
"""


@pytest.fixture
def graphs(tmp_path):
    path = tmp_path / "scene-STITCH-GRAPH.txt"
    path.write_text(GRAPH_TEXT)
    return stitch_graph.parse_stitch_graph(path), jax_graph.parse_stitch_graph(str(path))


def _fields(g):
    return (g.center_index, g.center_rotation, g.images_count, g.edges)


def test_parse_matches_jax(graphs):
    got, want = graphs
    assert _fields(got) == _fields(want)
    assert got.edges == ((0, 1), (0, 4), (1, 2), (2, 3), (2, 5), (3, 4))
    assert (got.center_index, got.center_rotation, got.images_count) == (1, 0.125, 6)


def test_bfs_parents_and_neighbors_match_jax(graphs):
    got, want = graphs
    assert got.bfs_parents() == want.bfs_parents()
    for i in range(got.images_count):
        assert got.neighbors(i) == want.neighbors(i)


@pytest.mark.parametrize("available", [3, 1, 5])
def test_subset_matches_jax(graphs, available):
    """``subset(3)`` keeps the center; ``subset(1)`` re-centres on the best
    connected available image."""
    got, want = graphs
    s, w = got.subset(available), want.subset(available)
    assert _fields(s) == _fields(w)
    assert s.bfs_parents() == w.bfs_parents()
    if available == 1:
        assert s.center_index == 0 and s.edges == ()


def test_chain_graph_is_the_jax_cli_default():
    """The graph a scene directory without a graph file gets
    (``sift_tpu/cli.py:80-84``): edges (i, i + 1), center n // 2."""
    g = stitch_graph.chain_graph(35)
    assert g.center_index == 17 and g.images_count == 35
    assert g.edges == tuple((i, i + 1) for i in range(34))


@pytest.mark.parametrize("shape", [(17, 23), (16, 24), (2, 15, 20)])
@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_apply_convolution_matches_jax(shape, ksize):
    """float64, odd and even image shapes, an asymmetric kernel (so the
    transpose of the reference's index convention shows)."""
    rng = np.random.default_rng(ksize * 100 + len(shape))
    img = rng.uniform(0, 255, shape)
    kern = rng.normal(size=(ksize, ksize))
    got = conv.apply_convolution(torch.from_numpy(img), kern).numpy()
    want = np.asarray(jax_conv.apply_convolution(jnp.asarray(img), jnp.asarray(kern)))
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("sigma", [0.8, 1.6, 2.5])
def test_gaussian_kernel_and_subtract_match_jax(sigma):
    np.testing.assert_array_equal(conv.gaussian_kernel_2d(sigma),
                                  jax_conv.gaussian_kernel_2d(sigma))
    rng = np.random.default_rng(9)
    a, b = rng.normal(size=(2, 9, 11))
    np.testing.assert_array_equal(
        conv.subtract(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_conv.subtract(jnp.asarray(a), jnp.asarray(b))),
    )
