"""Parity of the port's connected components (``ops/graph.py``: label
propagation as torch ops on the matrix's device) with the JAX package's
``lax.while_loop`` and with scipy's ``connected_components``: the GridCal
flow of ``tests/test_graph.py`` (``LilMat`` -> ``C = Cf - Ct`` ->
``A = C C^T`` -> islands), random patterns, a synthetic grid with 30% of
its branches out (branch and bus graphs), and the edge cases.

Every comparison is exact: labels, the raw least-node labels and the
island index arrays are integers.
"""

import jax  # noqa: F401  (JAX on the CPU with x64, set up by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components
import torch

import csparse3_tpu as jt
import csparse3_tpu_torch as pt
from csparse3_tpu.ops import graph as jgraph
from csparse3_tpu_torch.models import grids as pgrids
from csparse3_tpu_torch.ops import graph as pgraph

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)


def _both(s):
    s = sp.csc_matrix(s)
    return pt.CSC.from_scipy(s, device="cpu"), jt.CSC.from_scipy(s)


def _check(p, j, s):
    """Labels of the port equal to the JAX package's and to scipy's (both
    number components by their least node), and the islands too."""
    lab = pt.component_labels(p)
    np.testing.assert_array_equal(lab, jt.component_labels(j))
    _, ref = connected_components(s, directed=False)
    np.testing.assert_array_equal(lab, ref)
    isl = pt.islands(p)
    assert len(isl) == len(jt.islands(j)) == ref.max() + 1
    for a, b in zip(isl, jt.islands(j)):
        np.testing.assert_array_equal(a, b)
    return lab


def _grid5_flow(mod, lines, **kw):
    n, m = 5, len(lines)
    f_mat = mod.LilMat(m, n, **kw)
    t_mat = mod.LilMat(m, n, **kw)
    for k, (f, t, *_) in enumerate(lines):
        f_mat[k, f - 1] = 1
        t_mat[k, t - 1] = 1
    C = f_mat.to_csc() - t_mat.to_csc()
    return C, C * C.t()


def test_grid5_flow_matches_jax_and_scipy(grid5_lines):
    Cp, Ap = _grid5_flow(pt, grid5_lines, device="cpu")
    Cj, Aj = _grid5_flow(jt, grid5_lines)
    for p, j in ((Cp, Cj), (Ap, Aj)):
        for got, ref in zip(p.np_arrays(), j.np_arrays()):
            np.testing.assert_array_equal(got, ref)
    isl = Ap.islands()
    assert len(isl) == 1
    np.testing.assert_array_equal(isl[0], np.arange(len(grid5_lines)))
    _check(Ap, Aj, Ap.to_scipy())
    bus = Cp.t() * Cp
    _check(bus, Cj.t() * Cj, bus.to_scipy())


@pytest.mark.parametrize("seed,n,density", [(0, 50, 0.02), (1, 100, 0.01),
                                            (2, 200, 0.005), (3, 30, 0.0)])
def test_islands_match_jax_and_scipy(seed, n, density):
    rng = np.random.RandomState(seed)
    a = sp.random(n, n, density=density, random_state=rng, format="csc")
    s = (a + a.T).tocsc()
    p, j = _both(s)
    _check(p, j, s)
    # the one-sided pattern: both packages symmetrize the edge stream
    p1, j1 = _both(a)
    _check(p1, j1, a)


def test_raw_labels_and_rounds_match_the_jax_propagation():
    rng = np.random.RandomState(7)
    s = sp.random(300, 300, density=0.004, random_state=rng, format="csc")
    p, j = _both(s)
    raw, rounds = pgraph.propagate_labels(p)
    ip = np.asarray(s.indptr)
    cols = np.repeat(np.arange(300), np.diff(ip)).astype(np.int32)
    ref = jgraph._propagate(jnp.asarray(s.indices, dtype=jnp.int32),
                            jnp.asarray(cols), 300)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(ref))
    # the least node of each component
    _, lab = connected_components(s, directed=False)
    least = np.full(lab.max() + 1, 300)
    np.minimum.at(least, lab, np.arange(300))
    np.testing.assert_array_equal(raw.numpy(), least[lab])
    assert 1 <= rounds <= 20


def test_two_islands_match_jax():
    rows = [0, 1, 2, 3, 4, 5]
    cols = [1, 2, 0, 4, 5, 3]
    p = pt.from_triplets(rows, cols, np.ones(6), (6, 6), device="cpu")
    isl = pt.islands(p)
    assert len(isl) == 2
    np.testing.assert_array_equal(isl[0], [0, 1, 2])
    np.testing.assert_array_equal(isl[1], [3, 4, 5])
    for a, b in zip(isl, jt.islands(jt.from_triplets(rows, cols, np.ones(6),
                                                     (6, 6)))):
        np.testing.assert_array_equal(a, b)


def test_synthetic_grid_with_branches_out_matches_jax_and_scipy():
    """A 3000-bus grid with 30% of its branches out (kept where
    RandomState(0).rand(n_branch) > 0.3), through ``LilMat`` bulk chunks:
    the branch graph C C^T and the bus graph C^T C (isolated buses are
    islands of their own)."""
    g = pgrids.synthetic_grid(3000, seed=0)
    keep = np.random.RandomState(0).rand(g.n_branch) > 0.3
    f, t = g.f[keep], g.t[keep]
    nbr = len(f)
    mats = {}
    for mod, kw in ((pt, {"device": "cpu"}), (jt, {})):
        cf = mod.LilMat(nbr, g.n_bus, **kw).add_triplets(
            np.arange(nbr), f, 1.0)
        ct = mod.LilMat(nbr, g.n_bus, **kw).add_triplets(
            np.arange(nbr), t, 1.0)
        C = cf.to_csc() - ct.to_csc()
        mats[mod] = (C * C.t(), C.t() * C)
    counts = []
    for p, j in zip(mats[pt], mats[jt]):
        lab = _check(p, j, p.to_scipy())
        counts.append(lab.max() + 1)
    assert counts[0] > 1 and counts[1] > 1


def test_empty_and_non_square_match_jax():
    p, j = _both(sp.csc_matrix((0, 0)))
    assert pt.islands(p) == jt.islands(j) == []
    p, j = _both(sp.csc_matrix((4, 4)))
    np.testing.assert_array_equal(pt.component_labels(p),
                                  jt.component_labels(j))
    assert len(pt.islands(p)) == 4
    p, j = _both(sp.random(3, 5, density=0.5, random_state=1, format="csc"))
    for f in (pt.islands, pt.component_labels):
        with pytest.raises(ValueError, match="square"):
            f(p)
    with pytest.raises(ValueError, match="square"):
        jt.component_labels(j)
