"""The port's multicolour Gauss-Seidel, SOR, their smoothers and the MIS
aggregation against the JAX package's, on the CPU.

The cases of tests/test_relaxation.py and test_precond.py:101-115 on the
same seeded numpy inputs: a Gauss-Seidel sweep in each direction and an
SOR sweep within 1e-5 (f32) and 1e-12 (f64) of the JAX package's (the
colourings are equal, tests/test_torch_graph.py), the MIS aggregates equal
exactly, and the AMG-CG iteration counts equal for aggregator='mis' and
smoother='gauss_seidel' or 'sor'."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cusp_autotuned_tpu import gallery as jgallery, precond as jprecond
from cusp_autotuned_tpu import relaxation as jrelaxation, solvers as jsolvers
from cusp_autotuned_tpu.precond import smoothers as jsmoothers
from cusp_autotuned_tpu.precond.aggregation import aggregate as jaggregate
from cusp_autotuned_tpu.solvers import Monitor as JMonitor

from cusp_autotuned_tpu_torch import precond, relaxation, solvers
from cusp_autotuned_tpu_torch.backend.reference import to_scipy
from cusp_autotuned_tpu_torch.precond import smoothers
from cusp_autotuned_tpu_torch.precond.aggregation import aggregate
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor

from tests.torch_parity import one_thread, port_of  # noqa: F401

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
DIRECTIONS = [relaxation.FORWARD, relaxation.BACKWARD, relaxation.SYMMETRIC]


def _system(n, dtype):
    J = jgallery.poisson5pt(n, n, format="csr", dtype=dtype)
    rng = np.random.RandomState(0)
    return J, port_of(J), rng.randn(J.num_rows).astype(dtype), \
        rng.randn(J.num_rows).astype(dtype)


def _close(got, want, dtype):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_gauss_seidel_sweep_matches_jax(dtype, direction):
    J, A, b, x0 = _system(10, dtype)
    M = relaxation.gauss_seidel(A, default_direction=direction)
    Mj = jrelaxation.gauss_seidel(J, default_direction=direction)
    assert M.num_colors == Mj.num_colors
    np.testing.assert_array_equal(M.colors.numpy(), np.asarray(Mj.colors))
    x, xj = torch.from_numpy(x0), x0
    for _ in range(3):
        x, xj = M(A, torch.from_numpy(b), x), Mj(J, b, xj)
    _close(x, xj, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sor_sweep_matches_jax(dtype):
    J, A, b, x0 = _system(10, dtype)
    got = relaxation.sor(A, omega=1.2)(A, torch.from_numpy(b), torch.from_numpy(x0))
    _close(got, jrelaxation.sor(J, omega=1.2)(J, b, x0), dtype)
    got = relaxation.sor(A, omega=0.8)(A, torch.from_numpy(b), torch.from_numpy(x0),
                                       direction=relaxation.BACKWARD)
    _close(got, jrelaxation.sor(J, omega=0.8)(J, b, x0, direction="backward"), dtype)


def test_gauss_seidel_matches_sequential():
    """Multicolour GS equals sequential GS in colour order."""
    _, A, b, _ = _system(4, np.float64)
    M = relaxation.gauss_seidel(A)
    x = M(A, torch.from_numpy(b), torch.zeros(A.num_rows, dtype=torch.float64))
    S = to_scipy(A).toarray()
    xs = np.zeros(A.num_rows)
    for i in np.argsort(M.colors.numpy(), kind="stable"):
        xs[i] = (b[i] - S[i] @ xs + S[i, i] * xs[i]) / S[i, i]
    np.testing.assert_allclose(x.numpy(), xs, rtol=1e-10)


@pytest.mark.parametrize("name", ["gauss_seidel_smoother", "sor_smoother"])
def test_smoothers_match_jax(name):
    J, A, b, x0 = _system(9, np.float64)
    S, Sj = getattr(smoothers, name)(A), getattr(jsmoothers, name)(J)
    bt = torch.from_numpy(b)
    _close(S.presmooth(A, bt), Sj.presmooth(J, b), np.float64)
    _close(S.postsmooth(A, bt, torch.from_numpy(x0)), Sj.postsmooth(J, b, x0),
           np.float64)


@pytest.mark.parametrize("seed", [0, 5])
def test_mis_aggregate_matches_jax(seed):
    J = jgallery.poisson5pt(13, 11, format="csr", dtype=np.float64)
    agg, roots = aggregate.mis_aggregate(port_of(J), seed=seed)
    jagg, jroots = jaggregate.mis_aggregate(J, seed=seed)
    np.testing.assert_array_equal(agg, jagg)
    np.testing.assert_array_equal(roots, jroots)
    assert agg.dtype == roots.dtype == np.int32


def test_mis_aggregate_on_a_path_and_isolated_vertices():
    """The JAX package's loop and the vectorised rounds agree where rows
    have no entries (each isolated vertex its own root) and every vertex
    gets an aggregate."""
    import scipy.sparse as sp
    from tests.util import build
    S = sp.diags([np.ones(5), np.ones(5)], [-1, 1], shape=(6, 6)).tocsr()
    S = sp.block_diag([S, sp.csr_matrix((3, 3))]).tocoo()
    J = build(S, "csr", dtype=np.float64)
    agg, roots = aggregate.mis_aggregate(port_of(J))
    jagg, jroots = jaggregate.mis_aggregate(J)
    np.testing.assert_array_equal(agg, jagg)
    np.testing.assert_array_equal(roots, jroots)
    assert (agg >= 0).all() and np.unique(agg).size == roots.size


@pytest.mark.parametrize("kw", [{"aggregator": "mis"}, {"smoother": "gauss_seidel"},
                                {"smoother": "sor"},
                                {"aggregator": "mis", "smoother": "gauss_seidel"}])
def test_amg_cg_iterations_match_jax(kw):
    J = jgallery.poisson5pt(12, 12, format="csr", dtype=np.float64)
    A = port_of(J)
    b = np.ones(A.num_rows)
    Mj = jprecond.smoothed_aggregation(J, min_level_size=30, **kw)
    _, mj = jsolvers.cg(J, jnp.asarray(b), M=Mj, monitor=JMonitor(jnp.asarray(b), 100, 1e-8))
    M = precond.smoothed_aggregation(A, min_level_size=30, **kw)
    bt = torch.from_numpy(b)
    _, mon = solvers.cg(A, bt, M=M, monitor=Monitor(bt, 100, 1e-8))
    assert mon.converged() and mj.converged()
    assert mon.iteration_count() == mj.iteration_count()
