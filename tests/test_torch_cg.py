"""The port's main path as a whole, against the JAX package: the cg.cu flow
(poisson5pt, a via_dia operator, CG under a Monitor at rtol 1e-5) at
32 x 32, on the CPU."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusp_autotuned_tpu import gallery as jgallery, solvers as jsolvers
from cusp_autotuned_tpu.operators import planned_operator as jax_planned_operator
from cusp_autotuned_tpu.solvers.monitor import Monitor as JaxMonitor

from cusp_autotuned_tpu_torch import gallery, solvers
from cusp_autotuned_tpu_torch.operators import PlannedOperator, planned_operator
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor

from tests.torch_parity import one_thread, port_of  # noqa: F401

cg_module = importlib.import_module("cusp_autotuned_tpu_torch.solvers.cg")


def _b(n, dtype):
    return np.random.RandomState(0).rand(n).astype(dtype)


def _jax_solve(J, b, limit, config=None):
    op = J if config is None else jax_planned_operator(J, config)
    x, mon = jsolvers.cg(op, jnp.asarray(b), monitor=JaxMonitor(jnp.asarray(b), limit, 1e-5))
    return np.asarray(x), mon


def _port_solve(P, b, limit, config=None):
    op = P if config is None else planned_operator(P, config)
    bt = torch.from_numpy(b)
    x, mon = solvers.cg(op, bt, monitor=Monitor(bt, limit, 1e-5))
    return x.numpy(), mon


@pytest.mark.parametrize("limit", [2000, 10])
def test_cgcu_via_dia_matches_jax_f32(limit):
    """Converged (73 iterations) and limit-reached (10) solves."""
    J = jgallery.poisson5pt(32, 32, format="csr", dtype=np.float32)
    b = _b(J.num_rows, np.float32)
    xj, mj = _jax_solve(J, b, limit, {"impl": "via_dia", "dia_impl": "pallas",
                                      "block_rows": 1024})
    op = planned_operator(port_of(J), {"impl": "via_dia", "dia_impl": "cuda"})
    assert isinstance(op, PlannedOperator) and op.impl == "via_dia"
    xp, mp = _port_solve(op, b, limit)
    assert mp.iteration_count() == mj.iteration_count() == min(limit, 73)
    assert mp.converged() == mj.converged() == (limit > 73)
    np.testing.assert_allclose(mp.residuals, mj.residuals, rtol=1e-4)
    np.testing.assert_allclose(xp, xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())


@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_cg_default_operators_match_jax_f64(fmt):
    J = jgallery.poisson5pt(32, 32, format=fmt, dtype=np.float64)
    b = _b(J.num_rows, np.float64)
    xj, mj = _jax_solve(J, b, 2000)
    xp, mp = _port_solve(port_of(J), b, 2000)
    assert mp.iteration_count() == mj.iteration_count()
    np.testing.assert_allclose(mp.residuals, mj.residuals, rtol=1e-10)
    np.testing.assert_allclose(xp, xj, rtol=1e-10)


@pytest.mark.parametrize("limit", [2000, 40, 5])
def test_blocked_stop_check_equals_per_iteration(monkeypatch, limit):
    """Reading the stop flag once per block of iterations, with the tail of
    the block masked, gives bit for bit the solve that reads it every
    iteration."""
    A = gallery.poisson5pt(20, 20, format="dia", device="cpu")
    b = torch.from_numpy(_b(A.num_rows, np.float32))
    x_blk, m_blk = solvers.cg(A, b, monitor=Monitor(b, limit, 1e-5))
    monkeypatch.setattr(cg_module, "CHECK_EVERY", 1)
    x_one, m_one = solvers.cg(A, b, monitor=Monitor(b, limit, 1e-5))
    assert m_blk.iteration_count() == m_one.iteration_count()
    assert m_blk.residuals == m_one.residuals
    assert torch.equal(x_blk, x_one)


def test_cg_defaults_and_x0():
    """No monitor: 500 iterations at rtol 1e-5; a solution as x0 stops at 0."""
    A = gallery.poisson5pt(10, 10, format="csr", device="cpu")
    b = torch.from_numpy(_b(A.num_rows, np.float32))
    x, mon = solvers.cg(A, b)
    assert mon.iteration_limit() == 500 and mon.converged()
    x2, mon2 = solvers.cg(A, b, x0=torch.linalg.solve(
        torch.from_numpy(A.to_scipy().toarray()), b))
    assert mon2.iteration_count() == 0 or mon2.residuals[-1] <= mon2.tolerance()


@pytest.mark.parametrize("verb", ["dotc", "nrm2", "axpy", "axpby"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_blas_verbs_match_jax(verb, dtype):
    from cusp_autotuned_tpu.ops import blas as jblas
    from cusp_autotuned_tpu_torch.ops import blas
    rng = np.random.RandomState(9)
    x, y = (rng.randn(2, 1000) + (1j * rng.randn(2, 1000) if dtype == np.complex64
                                   else 0)).astype(dtype)
    args = {"dotc": (), "nrm2": None, "axpy": (0.5,), "axpby": (0.5, -2.0)}[verb]
    if args is None:
        want, got = jblas.nrm2(jnp.asarray(x)), blas.nrm2(torch.from_numpy(x))
    else:
        want = getattr(jblas, verb)(jnp.asarray(x), jnp.asarray(y), *args)
        got = getattr(blas, verb)(torch.from_numpy(x), torch.from_numpy(y), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
