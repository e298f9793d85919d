"""The port's graph module against the JAX package's, on the CPU.

The cases of tests/test_graph.py and the RCM cases of tests/test_native.py,
on the same seeded numpy inputs in both packages: BFS levels and
predecessors, component labels, MIS stencils (k = 1, 2), colours, the RCM
permutation, the pseudo-peripheral vertex and the Hilbert parts are equal
exactly; generalized_spmv with add, max, min, mul and a custom reduce
within 1e-6 relative.  The native orderings are held to their plain Python
versions as well."""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

import jax
import jax.numpy as jnp
from cusp_autotuned_tpu import gallery as jgallery, graph as jgraph
from cusp_autotuned_tpu.ops.multiply import generalized_spmv as jgeneralized_spmv

from cusp_autotuned_tpu_torch import formats as F, gallery, graph, multiply, transpose
from cusp_autotuned_tpu_torch.backend.reference import from_scipy, to_scipy
from cusp_autotuned_tpu_torch.graph import ordering
from cusp_autotuned_tpu_torch.ops import generalized_spmv
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.ops.segment import segment_reduce

from tests.torch_parity import one_thread, port_of  # noqa: F401
from tests.util import build

SPMV_RTOL = 1e-6


def _grid(m, n):
    """(JAX container, port container) of grid2d(m, n), unit entries."""
    J = jgallery.grid2d(m, n, format="csr")
    return J, port_of(J)


def _two_components():
    S = sp.block_diag([sp.coo_matrix(np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]])),
                       sp.coo_matrix(np.array([[0, 1], [1, 0]]))]).tocoo()
    J = build(S, "csr")
    return J, port_of(J)


def _equal(port, jax_value):
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_value))


@pytest.mark.parametrize("case,src", [("grid 5x5", 0), ("grid 5x5", 12),
                                      ("two components", 0)])
def test_bfs_levels_match_jax(case, src):
    J, P = _grid(5, 5) if case == "grid 5x5" else _two_components()
    levels = graph.breadth_first_search(P, src)
    assert levels.dtype == torch.int32
    _equal(levels, jgraph.breadth_first_search(J, src))
    dist = csgraph.shortest_path(to_scipy(P).tocsr(), unweighted=True, indices=src)
    np.testing.assert_array_equal(levels.numpy(),
                                  np.where(np.isinf(dist), -1, dist).astype(int))


def test_bfs_predecessors_match_jax():
    J, P = _grid(4, 4)
    pred = graph.breadth_first_search(P, 0, mark_levels=False)
    _equal(pred, jgraph.breadth_first_search(J, 0, mark_levels=False))
    S = to_scipy(P).tocsr()
    dist = csgraph.shortest_path(S, unweighted=True, indices=0)
    assert pred[0] == 0
    for v in range(1, P.num_rows):
        p = int(pred[v])
        assert S[p, v] != 0 and dist[p] == dist[v] - 1


@pytest.mark.parametrize("every", [1, 5])
def test_bfs_blocked_stop_check_gives_the_same_labels(monkeypatch, every):
    """The host reads the empty-frontier flag once per cg.CHECK_EVERY
    levels; the levels of a block past the fixpoint change nothing."""
    _, P = _grid(6, 7)
    want = graph.breadth_first_search(P, 3)
    want_pred = graph.breadth_first_search(P, 3, mark_levels=False)
    cg = importlib.import_module("cusp_autotuned_tpu_torch.solvers.cg")
    monkeypatch.setattr(cg, "CHECK_EVERY", every)
    assert torch.equal(graph.breadth_first_search(P, 3), want)
    assert torch.equal(graph.breadth_first_search(P, 3, mark_levels=False), want_pred)


def test_bfs_follows_the_pattern_not_the_values():
    """poisson5pt's off-diagonal entries are -1: an edge is a stored entry,
    as in CUSP, so the levels are the grid's hop distances (the JAX
    package's level sweep tests A f > 0 and stops at the source here)."""
    A = gallery.poisson5pt(9, 6, format="csr", device="cpu")
    levels = graph.breadth_first_search(A, 0)
    dist = csgraph.shortest_path(abs(to_scipy(A).tocsr()), unweighted=True,
                                 indices=0)
    np.testing.assert_array_equal(levels.numpy(), dist.astype(int))
    assert int(levels.max()) == 8 + 5
    D = convert(A, "dia")
    assert torch.equal(graph.breadth_first_search(D, 0), levels)


def test_connected_components_match_jax():
    J, P = _two_components()
    count, labels = graph.connected_components(P)
    jcount, jlabels = jgraph.connected_components(J)
    assert count == jcount == 2
    _equal(labels, jlabels)


def test_cc_multi_component_symmetric_matches_jax_and_scipy():
    rng = np.random.RandomState(0)
    blocks = [sp.random(200, 200, density=0.015, random_state=rng) + sp.eye(200)
              for _ in range(4)]
    S = sp.block_diag(blocks).tocsr()
    S = (S + S.T).tocsr()
    J = build(S.tocoo(), "csr")
    count, labels = graph.connected_components(port_of(J))
    jcount, jlabels = jgraph.connected_components(J)
    nc_ref, lab_ref = csgraph.connected_components(S, directed=False)
    assert count == jcount == nc_ref
    _equal(labels, jlabels)
    assert len(set(zip(labels.tolist(), lab_ref.tolist()))) == nc_ref


@pytest.mark.parametrize("k,seed", [(1, 0), (2, 0), (2, 7)])
def test_mis_matches_jax(k, seed):
    J, P = _grid(6, 6)
    count, stencil = graph.maximal_independent_set(P, k=k, seed=seed)
    jcount, jstencil = jgraph.maximal_independent_set(J, k=k, seed=seed)
    assert count == jcount == int(stencil.sum()) > 0
    _equal(stencil, jstencil)
    dist = csgraph.shortest_path(to_scipy(P).tocsr(), unweighted=True)
    sel = np.nonzero(stencil.numpy())[0]
    off = ~np.eye(sel.size, dtype=bool)
    assert (dist[np.ix_(sel, sel)][off] > k).all()           # independent
    assert (dist[:, sel].min(axis=1) <= k).all()              # maximal


@pytest.mark.parametrize("seed", [0, 3])
def test_vertex_coloring_matches_jax(seed):
    J, P = _grid(6, 6)
    ncolors, colors = graph.vertex_coloring(P, seed=seed)
    jncolors, jcolors = jgraph.vertex_coloring(J, seed=seed)
    assert ncolors == jncolors == int(colors.max()) + 1
    _equal(colors, jcolors)
    S = to_scipy(P).tocoo()
    off = S.row != S.col
    assert (colors[S.row[off]] != colors[S.col[off]]).all()


def test_pseudo_peripheral_matches_jax_and_the_plain_version():
    J = jgallery.grid2d(2, 10, format="csr")
    P = port_of(J)
    v = graph.pseudo_peripheral_vertex(P)
    assert v == jgraph.pseudo_peripheral_vertex(J)
    assert v == ordering.pseudo_peripheral_host(*ordering._adjacency(P))
    ecc = csgraph.shortest_path(to_scipy(P).tocsr(), unweighted=True).max(axis=1)
    assert ecc[v] == ecc.max()


@pytest.mark.parametrize("n,seed", [(12, 0), (15, 3)])
def test_symmetric_rcm_matches_jax_and_the_plain_version(n, seed):
    p = np.random.RandomState(seed).permutation(n * n)
    Ssc = to_scipy(gallery.poisson5pt(n, n, format="coo", device="cpu")
                   ).tocsr()[p][:, p].tocoo()
    J = build(Ssc, "csr")
    A = port_of(J)
    P = graph.symmetric_rcm(A)
    assert isinstance(P, F.PermutationMatrix) and P.perm.dtype == torch.int32
    perm = P.perm.numpy()
    np.testing.assert_array_equal(perm, np.asarray(jgraph.symmetric_rcm(J).perm))
    np.testing.assert_array_equal(perm, ordering.rcm_host(*ordering._adjacency(A)))
    np.testing.assert_array_equal(np.sort(perm), np.arange(n * n))
    reordered = Ssc.tocsr()[perm][:, perm].tocoo()
    bw_after = np.abs(reordered.row - reordered.col).max()
    assert bw_after < np.abs(Ssc.row - Ssc.col).max() and bw_after <= 2 * n


def test_rcm_of_a_graph_with_several_components():
    J, P = _two_components()
    perm = graph.symmetric_rcm(P).perm.numpy()
    np.testing.assert_array_equal(perm, np.asarray(jgraph.symmetric_rcm(J).perm))
    np.testing.assert_array_equal(perm, ordering.rcm_host(*ordering._adjacency(P)))


def test_hilbert_curve_matches_jax():
    rng = np.random.RandomState(1)
    pts = rng.rand(1000, 2)
    parts = graph.hilbert_curve(pts, 4, device="cpu")
    _equal(parts, jgraph.hilbert_curve(pts, 4))
    counts = np.bincount(parts.numpy(), minlength=4)
    assert counts.max() - counts.min() <= 1
    pts3 = rng.rand(500, 3)
    parts3 = graph.hilbert_curve(torch.from_numpy(pts3), 8)   # on pts3's device
    assert parts3.device.type == "cpu"
    _equal(parts3, jgraph.hilbert_curve(pts3, 8))
    with pytest.raises(ValueError):
        graph.hilbert_curve(rng.rand(10, 4), 2, device="cpu")


def _reduces():
    """(port reduce, JAX reduce, port combine, JAX combine) by name."""
    mul = (lambda a, b: a * b, lambda a, b: a * b)
    return {"add": (torch.add, jnp.add, *mul),
            "max": (torch.maximum, jnp.maximum, *mul),
            "min": (torch.minimum, jnp.minimum, *mul),
            "mul": (torch.mul, jnp.multiply, lambda a, b: 1 + 0.1 * a * b,
                    lambda a, b: 1 + 0.1 * a * b),
            # a reduce with no scatter mode: the sort and the segmented scan
            "logaddexp": (torch.logaddexp, jnp.logaddexp, *mul)}


@pytest.mark.parametrize("name", ["add", "max", "min", "mul", "logaddexp"])
@pytest.mark.parametrize("fmt", ["csr", "coo", "ell", "hyb", "dia"])
def test_generalized_spmv_matches_jax(fmt, name):
    reduce, jreduce, combine, jcombine = _reduces()[name]
    rng = np.random.RandomState(2)
    S = (sp.random(40, 30, density=0.12, random_state=rng, dtype=np.float64)
         + sp.eye(40, 30)).tocoo()
    S.data = S.data.astype(np.float32)
    S = sp.vstack([S.tocsr()[:35], sp.csr_matrix((5, 30), dtype=np.float32)])
    J = build(S.tocoo(), fmt)
    A = from_scipy(S, fmt, device="cpu")
    x = rng.uniform(-1, 1, 30).astype(np.float32)
    y = rng.uniform(-1, 1, 40).astype(np.float32)
    got = generalized_spmv(A, torch.from_numpy(x), torch.from_numpy(y),
                           lambda v: 2 * v, combine, reduce)
    # one jitted program: eagerly, the JAX scan compiles op by op (~10 s)
    want = np.asarray(jax.jit(lambda J, x, y: jgeneralized_spmv(
        J, x, y, lambda v: 2 * v, jcombine, jreduce))(J, x, y))
    np.testing.assert_allclose(got.numpy(), want, rtol=SPMV_RTOL, atol=1e-7)
    np.testing.assert_array_equal(got[35:].numpy(), 2 * y[35:])  # rows with no entry


def test_segment_reduce_matches_a_loop():
    """An associative reduce that does not commute (2x2 matrix products)
    comes out in entry order, as a left fold per segment."""
    rng = np.random.RandomState(4)
    rows = np.sort(rng.randint(0, 12, 50))
    vals = rng.uniform(0.5, 1.5, (50, 2, 2))
    contrib, mask = segment_reduce(torch.from_numpy(vals), torch.from_numpy(rows),
                                   10, torch.matmul)
    for r in range(10):
        hit = np.nonzero(rows == r)[0]
        assert bool(mask[r]) == (hit.size > 0)
        want = np.zeros((2, 2))
        if hit.size:
            want = vals[hit[0]]
            for e in hit[1:]:
                want = want @ vals[e]
        np.testing.assert_allclose(contrib[r].numpy(), want, rtol=1e-12)


def test_permutation_matrix_applies_and_transposes():
    perm = np.array([2, 0, 3, 1], np.int64)
    P = F.permutation_matrix(perm, device="cpu")
    assert P.shape == (4, 4) and P.nnz == 4 and P.perm.dtype == torch.int32
    x = torch.arange(4.0) * 10
    assert multiply(P, x).tolist() == [20.0, 0.0, 30.0, 10.0]
    assert P(x).tolist() == [20.0, 0.0, 30.0, 10.0]
    assert multiply(transpose(P), multiply(P, x)).tolist() == x.tolist()
    assert F.permutation_matrix(torch.tensor([1, 0])).device.type == "cpu"
