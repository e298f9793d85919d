"""The port's GMRES against the JAX package's on two harder systems of
tests/test_krylov.py, on the CPU: a complex one (conjugated CGS2 and
complex-safe rotations), and a badly row-scaled one with and without the
diagonal preconditioner (the case's AINV half waits for the port's AINV).
The same call on both packages, held to the agreement of
tests/krylov_parity.py."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from cusp_autotuned_tpu import precond as jprecond, solvers as js
from cusp_autotuned_tpu.backend.reference import from_scipy as jfrom_scipy

from cusp_autotuned_tpu_torch import precond, solvers

from tests.krylov_parity import DTYPES, agree, resid, solve
from tests.torch_parity import one_thread, port_of  # noqa: F401


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_gmres_complex(dtype):
    """Conjugated CGS2 and complex-safe rotations."""
    rng = np.random.RandomState(11)
    n = 60
    S = sp.random(n, n, density=0.08, random_state=rng).astype(np.complex128)
    S.data = S.data + 1j * rng.randn(S.data.size)
    S = S + sp.diags(np.full(n, 5.0 + 1.0j))
    J = jfrom_scipy(S.astype(dtype).tocoo(), "csr")
    b = (rng.randn(n) + 1j * rng.randn(n)).astype(dtype)
    out = solve(js.gmres, solvers.gmres, J, b, 300, 1e-9, restart=25)
    agree(*out, dtype)
    expect = spla.spsolve(S.tocsr(), b.astype(np.complex128))
    err = np.linalg.norm(out[2] - expect) / np.linalg.norm(expect)
    assert err < (1e-6 if dtype == np.complex128 else 1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gmres_nonsym_with_diagonal(dtype):
    """tests/test_krylov.py's badly row-scaled system: GMRES with the
    diagonal preconditioner (its AINV half waits for the port's AINV)
    converges in fewer iterations than without it."""
    rng = np.random.RandomState(11)
    n = 150
    S = sp.random(n, n, density=0.03, random_state=rng, dtype=np.float64)
    scale = 10.0 ** (1.5 * rng.rand(n))
    S = sp.diags(scale) @ (S + sp.diags(np.full(n, 6.0)))
    J = jfrom_scipy(S.astype(dtype).tocoo(), "csr")
    b = np.ones(n, dtype)
    plain = solve(js.gmres, solvers.gmres, J, b, 300, 1e-8, restart=30)
    agree(*plain, dtype)
    diag = solve(js.gmres, solvers.gmres, J, b, 300, 1e-8, restart=30,
                  M=(jprecond.diagonal(J), precond.diagonal(port_of(J))))
    agree(*diag, dtype)
    assert diag[3].converged()
    assert diag[3].iteration_count() < plain[3].iteration_count()
    if dtype == np.float64:
        assert resid(J, diag[2], b) < 1e-5
