"""The port's Krylov solvers against the JAX package's, on the CPU: the
cases of tests/test_krylov.py for bicgstab, bicg, cr, cg_m and bicgstab_m
as the same call on both packages, in f64 and in f32, held to the
agreement of tests/krylov_parity.py (GMRES's cases: test_torch_gmres.py)."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from cusp_autotuned_tpu import gallery as jgallery, solvers as js

from cusp_autotuned_tpu_torch import solvers

from tests.krylov_parity import (
    DTYPES, agree, diag_ops, nonsym, resid, solve, spd,
)
from tests.torch_parity import one_thread  # noqa: F401


@pytest.mark.parametrize("dtype", DTYPES)
def test_bicgstabspd(dtype):
    J = spd(15, dtype)
    b = np.ones(J.num_rows, dtype)
    out = solve(js.bicgstab, solvers.bicgstab, J, b, 400, 1e-8)
    agree(*out, dtype)
    if dtype == np.float64:
        assert out[3].converged() and resid(J, out[2], b) < 1e-7


@pytest.mark.parametrize("dtype", DTYPES)
def test_bicgstabnonsym(dtype):
    J = nonsym(dtype)
    b = np.ones(J.num_rows, dtype)
    out = solve(js.bicgstab, solvers.bicgstab, J, b, 500, 1e-8)
    agree(*out, dtype)
    if dtype == np.float64:
        assert out[3].converged() and resid(J, out[2], b) < 1e-7


@pytest.mark.parametrize("dtype", DTYPES)
def test_bicgstab_with_preconditioner(dtype):
    J = nonsym(dtype)
    b = np.ones(J.num_rows, dtype)
    out = solve(js.bicgstab, solvers.bicgstab, J, b, 500, 1e-8, M=diag_ops(J))
    agree(*out, dtype)
    assert out[3].converged()


@pytest.mark.parametrize("dtype", DTYPES)
def test_bicg(dtype):
    J = nonsym(dtype)
    b = np.ones(J.num_rows, dtype)
    out = solve(js.bicg, solvers.bicg, J, b, 500, 1e-8)
    agree(*out, dtype)
    if dtype == np.float64:
        assert out[3].converged() and resid(J, out[2], b) < 1e-7


@pytest.mark.parametrize("dtype", DTYPES)
def test_cr(dtype):
    J = spd(15, dtype)
    b = np.ones(J.num_rows, dtype)
    out = solve(js.cr, solvers.cr, J, b, 500, 1e-8)
    agree(*out, dtype)
    if dtype == np.float64:
        assert out[3].converged() and resid(J, out[2], b) < 1e-7


@pytest.mark.parametrize("dtype", DTYPES)
def test_cg_m_shifts(dtype):
    J = spd(10, dtype)
    b = np.ones(J.num_rows, dtype)
    sigma = np.array([0.1, 1.0, 5.0])
    out = solve(js.cg_m, solvers.cg_m, J, b, 600, 1e-9, sigma)
    agree(*out, dtype)
    S = J.to_scipy().tocsr().astype(np.float64)
    for s, xs in zip(sigma, out[2]):
        expect = spla.spsolve(S + s * sp.eye(J.num_rows), b.astype(np.float64))
        err = np.linalg.norm(xs - expect) / np.linalg.norm(expect)
        assert err < (1e-5 if dtype == np.float64 else 1e-4), s


@pytest.mark.parametrize("dtype", DTYPES)
def test_cg_m_zeta_underflow_freezes_shift(dtype):
    """tests/test_krylov.py's f32 case: the zeta of the shifts 0.5 and 2
    underflows in f32 before the seed system converges; a dead zeta freezes
    its shift and every shift solves to working precision."""
    J = jgallery.poisson5pt(16, 64, format="csr", dtype=dtype)
    b = np.ones(J.num_rows, dtype)
    sigma = np.array([0.0, 0.5, 2.0], dtype)
    out = solve(js.cg_m, solvers.cg_m, J, b, 80, 1e-6, sigma)
    agree(*out, dtype)
    S = J.to_scipy().astype(np.float64)
    for xs, s in zip(out[2], sigma):
        r = S @ xs + s * xs - b
        assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4, s


@pytest.mark.parametrize("dtype", DTYPES)
def test_bicgstab_m_shifts(dtype):
    J = nonsym(dtype, 120, seed=5)
    b = np.ones(J.num_rows, dtype)
    sigma = np.array([0.5, 2.0])
    out = solve(js.bicgstab_m, solvers.bicgstab_m, J, b, 800, 1e-9, sigma)
    agree(*out, dtype)
    S = J.to_scipy().tocsr().astype(np.float64)
    for s, xs in zip(sigma, out[2]):
        expect = spla.spsolve(S + s * sp.eye(J.num_rows), b.astype(np.float64))
        assert np.linalg.norm(xs - expect) / np.linalg.norm(expect) < 1e-4, s
