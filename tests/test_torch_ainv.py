"""The port's AINV preconditioners against the JAX package's, on the CPU.

The cases of tests/test_precond.py:26-61 and tests/test_native.py:16-57 on
the same f64 inputs: the applies of bridson_ainv and scaled_bridson_ainv
within 1e-6 of the JAX package's, with each dropping knob; the native
factorisations' factors and applies within 1e-6 of the plain Python
versions'; no dropping gives the exact inverse, for nonsym_bridson_ainv
too, where the JAX package's is not (the scipy oracle arbitrates); and the
preconditioned solves converge in fewer iterations than the plain ones."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from cusp_autotuned_tpu import gallery as jgallery, precond as jprecond
from cusp_autotuned_tpu import solvers as jsolvers
from cusp_autotuned_tpu.solvers import Monitor as JMonitor

from cusp_autotuned_tpu_torch import native, precond, solvers
from cusp_autotuned_tpu_torch.backend.reference import from_scipy, to_scipy
from cusp_autotuned_tpu_torch.precond import ainv
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor

from tests.torch_parity import one_thread, port_of  # noqa: F401
from tests.util import build

RTOL = 1e-6


def _poisson(n):
    J = jgallery.poisson5pt(n, n, format="csr", dtype=np.float64)
    return J, port_of(J)


def _nonsym(n, seed):
    rng = np.random.RandomState(seed)
    S = (sp.random(n, n, density=0.05 if n > 50 else 0.08, random_state=rng)
         + sp.diags(np.full(n, 4.0))).tocoo()
    J = build(S, "csr", dtype=np.float64)
    return J, port_of(J)


def _r(n, seed=1):
    return np.random.RandomState(seed).randn(n)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


KNOBS = [{"drop_tolerance": 0.05}, {"drop_tolerance": 0.0},
         {"drop_tolerance": 0.01, "nonzero_per_row": 3},
         {"drop_tolerance": 0.01, "lin_dropping": True, "lin_param": 2}]


@pytest.mark.parametrize("knobs", KNOBS)
@pytest.mark.parametrize("name", ["bridson_ainv", "scaled_bridson_ainv"])
def test_spd_ainv_applies_match_jax(name, knobs):
    J, A = _poisson(7)
    r = _r(A.num_rows)
    M = getattr(precond, name)(A, **knobs)
    assert M.z.dtype == torch.float64 and M.z.device.type == "cpu"
    _close(M(torch.from_numpy(r)), getattr(jprecond, name)(J, **knobs)(r))


def test_nonsym_ainv_is_the_inverse_without_dropping():
    """The biconjugation gives W^T A Z = D, so with nothing dropped M is
    A^-1 (the scipy oracle arbitrates).  The JAX package updates Z with
    W's multipliers and W with Z's, so its M is not A^-1: parity is not
    asserted for this variant."""
    J, A = _nonsym(40, 5)
    S = to_scipy(A).toarray()
    r = _r(40)
    want = np.linalg.solve(S, r)
    got = precond.nonsym_bridson_ainv(A, drop_tolerance=0.0)(torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-10)
    jax_m = np.asarray(jprecond.nonsym_bridson_ainv(J, drop_tolerance=0.0)(r))
    assert np.abs(jax_m - want).max() > 1e-2 * np.abs(want).max()


def _dense(triplets, n):
    rows, cols, vals = triplets
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).toarray()


@pytest.mark.parametrize("scaled", [False, True])
def test_native_spd_factors_match_the_plain_version(scaled):
    _, A = _poisson(6)
    S = to_scipy(A).tocsr()
    args = (S.indptr, S.indices, S.data, 0.05, -1, False, 1, scaled)
    *w, diag = native.ainv_spd(*args)
    *w_py, diag_py = ainv.ainv_spd_host(*args)
    np.testing.assert_allclose(_dense(w, 36), _dense(w_py, 36), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(diag, diag_py, rtol=RTOL)
    dinv = np.ones(36) if scaled else 1.0 / diag_py
    r = torch.from_numpy(_r(36))
    M_py = ainv.ainv_operator(A, tuple(w_py), tuple(w_py), dinv)
    M = precond.scaled_bridson_ainv(A, 0.05) if scaled else precond.bridson_ainv(A, 0.05)
    _close(M(r), M_py(r))


@pytest.mark.parametrize("knobs", KNOBS[:3])
def test_native_nonsym_factors_match_the_plain_version(knobs):
    _, A = _nonsym(40, 5)
    S = to_scipy(A).tocsr()
    St = S.T.tocsr()
    args = (S.indptr, S.indices, S.data, St.indptr, St.indices, St.data,
            knobs["drop_tolerance"], knobs.get("nonzero_per_row", -1), False, 1)
    z, w, diag = native.ainv_nonsym(*args)
    z_py, w_py, diag_py = ainv.ainv_nonsym_host(*args)
    for got, want in ((z, z_py), (w, w_py)):
        np.testing.assert_allclose(_dense(got, 40), _dense(want, 40), rtol=RTOL,
                                   atol=1e-12)
    np.testing.assert_allclose(diag, diag_py, rtol=RTOL)
    r = torch.from_numpy(_r(40))
    _close(precond.nonsym_bridson_ainv(A, **knobs)(r),
           ainv.ainv_operator(A, z_py, w_py, 1.0 / diag_py)(r))


def test_ainv_exact_when_no_dropping():
    _, A = _poisson(5)
    M = precond.bridson_ainv(A, drop_tolerance=0.0, nonzero_per_row=-1)
    r = _r(25, 0)
    np.testing.assert_allclose(M(torch.from_numpy(r)).numpy(),
                               np.linalg.solve(to_scipy(A).toarray(), r),
                               rtol=1e-8, atol=1e-9)


def test_ainv_cg_takes_fewer_iterations_than_plain_cg_as_in_jax():
    J, A = _poisson(10)
    b = np.ones(A.num_rows)
    bt = torch.from_numpy(b)
    _, plain = solvers.cg(A, bt, monitor=Monitor(bt, 400, 1e-8))
    M = precond.bridson_ainv(A, drop_tolerance=0.05)
    _, mon = solvers.cg(A, bt, M=M, monitor=Monitor(bt, 400, 1e-8))
    _, jmon = jsolvers.cg(J, jnp.asarray(b), M=jprecond.bridson_ainv(J, 0.05),
                          monitor=JMonitor(jnp.asarray(b), 400, 1e-8))
    assert mon.converged() and mon.iteration_count() < plain.iteration_count()
    assert mon.iteration_count() == jmon.iteration_count()
    M = precond.scaled_bridson_ainv(A, drop_tolerance=0.05)
    _, mon = solvers.cg(A, bt, M=M, monitor=Monitor(bt, 300, 1e-8))
    assert mon.converged()


def test_nonsym_ainv_with_bicgstab():
    _, A = _nonsym(80, 3)
    b = torch.ones(80, dtype=torch.float64)
    _, plain = solvers.bicgstab(A, b, monitor=Monitor(b, 300, 1e-8))
    M = precond.nonsym_bridson_ainv(A, drop_tolerance=0.05)
    x, mon = solvers.bicgstab(A, b, M=M, monitor=Monitor(b, 300, 1e-8))
    assert mon.converged() and mon.iteration_count() < plain.iteration_count()
    assert np.linalg.norm(b.numpy() - to_scipy(A) @ x.numpy()) < 1e-6


def test_ainv_factors_keep_a_f32_matrix_in_f32():
    S = to_scipy(_poisson(6)[1]).astype(np.float32)
    A = from_scipy(S, "csr", device="cpu")
    M = precond.bridson_ainv(A, 0.1)
    assert M.z.dtype == M.wt.dtype == M.diag_inv.dtype == torch.float32
    assert M(torch.ones(36)).dtype == torch.float32


def test_native_code_checks_its_arrays_before_the_call():
    with pytest.raises(ValueError, match="col"):
        native.rcm(np.array([0, 2]), np.array([0]))
    with pytest.raises(ValueError, match="val"):
        native.ainv_spd(np.array([0, 1]), np.array([0]), np.array([]), 0.1, -1,
                        False, 1, False)
    S = sp.eye(3, format="csr")
    with pytest.raises(ValueError, match="rows"):
        native.ainv_nonsym(S.indptr, S.indices, S.data, S.indptr[:3],
                           S.indices[:2], S.data[:2], 0.1, -1, False, 1)
