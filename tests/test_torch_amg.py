"""The port's smoothed-aggregation AMG against the JAX package's, on the CPU.

Both packages take the same f64 matrices (poisson5pt 40x40, poisson7pt
12x12x12, poisson27pt 9x9x9) and the same numpy right-hand sides.  The
set-up is host numpy and scipy in both, with the same arithmetic: the
strength graphs, the aggregates and the tentative prolongator are equal
exactly; rho(D^-1 A) to rtol 1e-10 (the same Ritz estimate, summed in the
same order); P, R and the Galerkin A_c to rtol 1e-12 (the closed-form
structured RAP sums in another order than a sparse product).  A V-cycle
equals the JAX package's to rtol 1e-10 in f64, and the AMG-CG iteration
counts are equal.  With spmv_config={} on a 3-D level the JAX package's
rails compute in f32 (they reject x64), so the port's planned V-cycle is
held to the JAX package's exact one, with the containers' products."""

import functools
import io

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery, precond as jprecond
from cusp_autotuned_tpu import solvers as jsolvers
from cusp_autotuned_tpu.backend.reference import (
    from_scipy as jfrom_scipy, to_scipy as jto_scipy,
)
from cusp_autotuned_tpu.precond.aggregation import (
    aggregate as jaggregate, smooth as jsmooth, strength as jstrength,
    structured_rap as jrap, tentative as jtentative,
)
from cusp_autotuned_tpu.relaxation.jacobi import jacobi as jjacobi
from cusp_autotuned_tpu.solvers import Monitor as JMonitor

from cusp_autotuned_tpu_torch import precond, solvers
from cusp_autotuned_tpu_torch.backend.reference import to_scipy
from cusp_autotuned_tpu_torch.formats.base import MatrixBase
from cusp_autotuned_tpu_torch.precond.aggregation import (
    aggregate, smooth, strength, structured_rap, tentative,
)
from cusp_autotuned_tpu_torch.relaxation import jacobi
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor

from tests.torch_parity import one_thread, port_of  # noqa: F401

RHO_RTOL = 1e-10
MATRIX_RTOL = 1e-12
CYCLE_RTOL = 1e-10


@functools.cache
def _matrix(name):
    """(JAX container, port container) in f64."""
    if name == "poisson5pt 40x40":
        J = jgallery.poisson5pt(40, 40, format="csr", dtype=np.float64)
    elif name == "poisson7pt 12^3":
        J = jgallery.poisson7pt(12, 12, 12, format="csr", dtype=np.float64)
    else:
        J = jgallery.poisson27pt(9, 9, 9, format="csr", dtype=np.float64)
    return J, port_of(J)


def _scipy(M):
    if sp.issparse(M):
        return M.tocsr()
    return (to_scipy(M) if isinstance(M, MatrixBase) else jto_scipy(M)).tocsr()


def _same(port, ref, rtol=MATRIX_RTOL):
    """Two matrices (the port's or the JAX package's containers, or scipy
    matrices) hold the same values to rtol of the largest."""
    a, b = _scipy(port), _scipy(ref)
    assert a.shape == b.shape
    diff = abs(a - b)
    assert diff.max() <= rtol * abs(b).max(), diff.max()


def _b(n, seed=0):
    return np.random.RandomState(seed).randn(n)


MATRICES = ["poisson5pt 40x40", "poisson7pt 12^3"]


@pytest.mark.parametrize("name", MATRICES)
def test_strength_rho_and_aggregates_match_jax(name):
    J, A = _matrix(name)
    assert strength.rho_Dinv_A(A) == pytest.approx(jstrength.rho_Dinv_A(J),
                                                   rel=RHO_RTOL)
    for theta in (0.0, 0.25):
        _same(strength.symmetric_strength_of_connection(A, theta),
              jstrength.symmetric_strength_of_connection(J, theta), rtol=0)
    _same(strength.evolution_strength_of_connection(A),
          jstrength.evolution_strength_of_connection(J), rtol=MATRIX_RTOL)
    assert aggregate.detect_grid(A) == jaggregate.detect_grid(J)
    C = strength.symmetric_strength_of_connection(A)
    for got, want in zip(aggregate.standard_aggregate(C),
                         jaggregate.standard_aggregate(
                             jstrength.symmetric_strength_of_connection(J))):
        np.testing.assert_array_equal(got, want)
    if aggregate.detect_grid(A) is not None:
        for got, want in zip(aggregate.structured_aggregate(A),
                             jaggregate.structured_aggregate(J)):
            np.testing.assert_array_equal(got, want)


def test_detect_grid_rejects_a_chain_and_ungridded_matrices():
    """A 1-D multi-band chain decomposes arithmetically but wraps rows: no
    grid, as in the JAX package; a 3-D stencil has none either."""
    n = 64
    S = sp.diags([np.ones(n - abs(o)) for o in (-4, -1, 0, 1, 4)],
                 (-4, -1, 0, 1, 4), format="csr")
    J = jfrom_scipy(S, "csr", dtype=np.float64)
    assert aggregate.detect_grid(port_of(J)) is None is jaggregate.detect_grid(J)
    assert aggregate.detect_grid(_matrix("poisson7pt 12^3")[1]) is None
    assert aggregate.detect_grid(_matrix("poisson5pt 40x40")[1]) == (40, 40)


@pytest.mark.parametrize("name", MATRICES)
def test_tentative_prolongator_and_galerkin_product_match_jax(name):
    J, A = _matrix(name)
    jagg = (jaggregate.structured_aggregate(J) if name.startswith("poisson5pt")
            else jaggregate.standard_aggregate(J))[0]
    B = np.ones(A.num_rows)
    T, Bc = tentative.fit_candidates(jagg, B, device="cpu")
    JT, JBc = jtentative.fit_candidates(jagg, B)
    _same(T, JT, rtol=0)
    np.testing.assert_array_equal(Bc, JBc)
    rho = jstrength.rho_Dinv_A(J)
    P = smooth.smooth_prolongator(A, T, rho_DinvA=rho)
    JP = jsmooth.smooth_prolongator(J, JT, rho_DinvA=rho)
    _same(P, JP)
    R = structured_rap.container_from_csr(to_scipy(P).T, P.dtype, "cpu")
    JR = jfrom_scipy(jto_scipy(JP).T.tocsr(), "csr", dtype=np.float64)
    _same(R, JR)
    _same(smooth.galerkin_product(R, A, P), jsmooth.galerkin_product(JR, J, JP))


def test_structured_rap_matches_the_generic_products():
    J, A = _matrix("poisson5pt 40x40")
    agg, _ = aggregate.structured_aggregate(A)
    T, _ = tentative.fit_candidates(agg, np.ones(A.num_rows), device="cpu")
    rho = strength.rho_Dinv_A(A)
    s = (4.0 / 3.0) / rho
    Tsp = to_scipy(T).tocsr()
    band = structured_rap.get_band(A)
    P64, Ac64 = structured_rap.structured_smooth_rap(
        to_scipy(A).tocsr(), Tsp.data, (40, 40), (3, 3), s, band=band)
    JP64, JAc64 = jrap.structured_smooth_rap(
        jto_scipy(J).tocsr(), Tsp.data, (40, 40), (3, 3), s)
    _same(P64, JP64, rtol=0)
    _same(Ac64, JAc64, rtol=0)
    P = smooth.smooth_prolongator(A, T, rho_DinvA=rho)
    _same(P64, P)
    R = structured_rap.container_from_csr(P64.T, A.dtype, "cpu")
    _same(Ac64, smooth.galerkin_product(R, A, P))


def test_get_band_builds_only_a_dense_enough_band_and_caches_nothing():
    """The JAX package caches a dense f64 array per diagonal on the container
    for up to 128 diagonals; the port builds a band only within the DIA fill
    guard and keeps none of it, while rho(D^-1 A) on a sparse band stays the
    JAX package's Ritz estimate (its CSR matvec sums in the band's order)."""
    J, A = _matrix("poisson5pt 40x40")
    offs, data = structured_rap.get_band(A)
    assert offs == [-40, -1, 0, 1, 40] and len(data) == 5
    assert "_band" not in A.__dict__
    # 121 diagonals (60 pairs of 4 entries each and the main one) on 12,000
    # rows: 1.45e6 padded values for 12,480 entries, past the fill guard
    n = 12_000
    rng = np.random.RandomState(9)
    rows = rng.randint(0, n - 3000, 240)
    cols = rows + np.repeat(np.arange(1, 61) * 25, 4)
    S = (sp.coo_matrix((rng.rand(240), (rows, cols)), shape=(n, n))
         + sp.eye(n) * 4).tocsr()
    S = S + S.T
    JS = jfrom_scipy(S, "csr", dtype=np.float64)
    PS = port_of(JS)
    assert structured_rap.get_band(PS) is None
    assert jrap.get_band(JS) is not None               # the JAX package's band
    assert strength.rho_Dinv_A(PS) == pytest.approx(jstrength.rho_Dinv_A(JS),
                                                    rel=RHO_RTOL)
    assert not [k for k in PS.__dict__ if "band" in k]


def _hierarchies(name, **kw):
    J, A = _matrix(name)
    return J, A, jprecond.smoothed_aggregation(J, **kw), \
        precond.smoothed_aggregation(A, **kw)


@pytest.mark.parametrize("name,kw", [
    ("poisson5pt 40x40", {}),
    ("poisson5pt 40x40", {"spmv_config": {}}),
    ("poisson7pt 12^3", {"min_level_size": 60}),
    ("poisson5pt 40x40", {"smoother": "polynomial"}),
])
def test_vcycle_matches_jax(name, kw):
    J, A, MJ, M = _hierarchies(name, **kw)
    assert len(M.levels) == len(MJ.levels) and M.coarse.n == MJ.coarse.n
    for lvl, jlvl in zip(M.levels, MJ.levels):
        _same(lvl.A, jlvl.A)
        _same(lvl.P, jlvl.P)
        _same(lvl.R, jlvl.R)
    b = _b(A.num_rows)
    np.testing.assert_allclose(M(torch.from_numpy(b)).numpy(), np.asarray(MJ(b)),
                               rtol=CYCLE_RTOL, atol=CYCLE_RTOL * np.abs(b).max())
    if kw.get("spmv_config") == {}:
        # the grid-blocked levels apply R and P factored around A in both
        for lvl, jlvl in zip(M.levels, MJ.levels):
            assert (lvl.Rop.impl, lvl.Pop.impl) == (jlvl.Rop.impl, jlvl.Pop.impl) \
                == ("factored", "factored")
            assert lvl.Aop.impl


def test_model_guided_fine_level_runs_on_the_dia_kernel():
    """tests/test_precond.py:288-305 in the port: the fine A of a 5-point
    stencil on via_dia, on a grid where the card's prices tell the DIA
    kernel from a one-launch rail (300 x 300, as the cost-model tests)."""
    from cusp_autotuned_tpu_torch import gallery
    A = gallery.poisson5pt(300, 300, format="csr", device="cpu")
    M = precond.smoothed_aggregation(A, spmv_config={})
    assert M.levels[0].Aop.impl == "via_dia"
    assert (M.levels[0].Rop.impl, M.levels[0].Pop.impl) == ("factored", "factored")
    b = torch.ones(A.num_rows)
    _, mon = solvers.cg(A, b, M=M, monitor=Monitor(b, 100, 1e-5))
    assert mon.converged() and mon.iteration_count() < 20


def test_planned_unstructured_vcycle_matches_the_exact_jax_cycle():
    J, A, MJ, M = _hierarchies("poisson7pt 12^3", min_level_size=60)
    P = precond.smoothed_aggregation(A, min_level_size=60, spmv_config={})
    assert all(op is not None for l in P.levels for op in (l.Aop, l.Rop, l.Pop))
    b = _b(A.num_rows, 1)
    np.testing.assert_allclose(P(torch.from_numpy(b)).numpy(), np.asarray(MJ(b)),
                               rtol=CYCLE_RTOL, atol=CYCLE_RTOL * np.abs(b).max())


@pytest.mark.parametrize("name,n,b_of,kw,limit,tol,its", [
    ("poisson5pt", 40, "bench", {}, 100, 1e-10, 19),
    ("poisson5pt", 150, "bench", {}, 100, 1e-10, 20),
    ("poisson27pt", 9, "randn", {"min_level_size": 60}, 100, 1e-8, None),
])
def test_amg_cg_iterations_match_jax(name, n, b_of, kw, limit, tol, its):
    """bench.py's amg_cg_iters configuration (b = 1.01 rand + 0.5 from seed
    7) at 40x40 and 150x150, and tests/test_precond.py:339's 3-D case."""
    if name == "poisson5pt":
        J = jgallery.poisson5pt(n, n, format="csr", dtype=np.float64)
    else:
        J = jgallery.poisson27pt(n, n, n, format="csr", dtype=np.float64)
    A = port_of(J)
    rng = np.random.RandomState(7 if b_of == "bench" else 1)
    b = 1.01 * rng.rand(A.num_rows) + 0.5 if b_of == "bench" else rng.randn(A.num_rows)
    _, mon_j = jsolvers.cg(J, b, M=jprecond.smoothed_aggregation(J, **kw),
                           monitor=JMonitor(b, limit, tol))
    bt = torch.from_numpy(b)
    x, mon = solvers.cg(A, bt, M=precond.smoothed_aggregation(A, **kw),
                        monitor=Monitor(bt, limit, tol))
    assert mon.converged() and mon_j.converged()
    assert mon.iteration_count() == mon_j.iteration_count()
    if its is not None:
        assert mon.iteration_count() == its
    r = b - to_scipy(A) @ x.numpy()
    assert np.linalg.norm(r) <= 10 * tol * np.linalg.norm(b)


def test_standalone_solve_and_report_match_jax():
    J, A, MJ, M = _hierarchies("poisson5pt 40x40", min_level_size=50)
    b = np.ones(A.num_rows)
    xj, mj = MJ.solve(b, monitor=JMonitor(b, 60, 1e-8))
    x, m = M.solve(torch.from_numpy(b), monitor=Monitor(torch.from_numpy(b), 60, 1e-8))
    assert m.converged() and m.iteration_count() == mj.iteration_count()
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    out, jout = io.StringIO(), io.StringIO()
    M.print(out)
    MJ.print(jout)
    assert out.getvalue() == jout.getvalue()
    assert M.operator_complexity() == pytest.approx(MJ.operator_complexity())
    assert set(M.setup_s) >= {"rho_DinvA", "aggregate", "prolongator and RAP"}


def test_tuned_levels_walk_once_and_reuse_the_cache(monkeypatch):
    """spmv_config={'tune': True, ...}: each level's A (from tune_min_rows
    rows) is walked by the global tuner once; a second set-up reuses its
    results (tests/test_precond.py:308 in the port; a validation-only tuner,
    as there)."""
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.autotune import tuner as tuner_mod
    monkeypatch.setattr(tuner_mod, "_global_tuner", tuner_mod.Tuner(measure=False))
    A = gallery.poisson5pt(20, 20, format="csr", device="cpu")
    cfg = {"tune": True, "tune_min_rows": 1}
    M = precond.smoothed_aggregation(A, min_level_size=30, spmv_config=cfg)
    store = tuner_mod.get_tuner().results[tuner_mod.matrix_signature(M.levels[0].A)]
    assert M.levels[0].Aop is not None and any(r.is_valid() for r in store.values())
    n_before = len(store)
    M2 = precond.smoothed_aggregation(A, min_level_size=30, spmv_config=cfg)
    assert len(store) == n_before and M2.levels[0].Aop is not None
    b = torch.ones(A.num_rows)
    _, mon = solvers.cg(A, b, M=M2, monitor=Monitor(b, 100, 1e-8))
    assert mon.converged()


def test_jacobi_relaxation_and_diagonal_preconditioner_match_jax():
    from cusp_autotuned_tpu.precond import diagonal as jdiagonal
    J, A = _matrix("poisson5pt 40x40")
    b, x0 = _b(A.num_rows, 2), _b(A.num_rows, 3)
    want = np.asarray(jjacobi(J, omega=0.7)(J, b, x0))
    got = jacobi(A, omega=0.7)(A, torch.from_numpy(b), torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)
    np.testing.assert_allclose(precond.diagonal(A)(torch.from_numpy(b)).numpy(),
                               np.asarray(jdiagonal(J)(b)), rtol=1e-15)


def test_unported_smoothers_and_aggregator_raise():
    """The Gauss-Seidel and SOR smoothers and the MIS aggregator, which
    raised until the graph slice was ported, raise no longer: each builds
    a hierarchy that preconditions CG to convergence (their iteration
    counts against the JAX package's: tests/test_torch_gauss_seidel.py)."""
    _, A = _matrix("poisson5pt 40x40")
    b = torch.from_numpy(_b(A.num_rows))
    for kw in ({"smoother": "gauss_seidel"}, {"smoother": "sor"},
               {"aggregator": "mis"}):
        M = precond.smoothed_aggregation(A, **kw)
        _, mon = solvers.cg(A, b, M=M, monitor=Monitor(b, 200, 1e-8))
        assert mon.converged(), kw
