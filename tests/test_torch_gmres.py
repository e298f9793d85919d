"""The port's GMRES against the JAX package's, on the CPU: the real GMRES
cases of tests/test_krylov.py as the same call on both packages, in f64
and in f32, held to the agreement of tests/krylov_parity.py (the complex
and the row-scaled cases: test_torch_gmres_complex_scaled.py)."""

import numpy as np
import pytest

from cusp_autotuned_tpu import solvers as js

from cusp_autotuned_tpu_torch import solvers

from tests.krylov_parity import (
    DTYPES, agree, diag_ops, nonsym, resid, solve, spd,
)
from tests.torch_parity import one_thread  # noqa: F401


@pytest.mark.parametrize("restart", [10, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gmres(dtype, restart):
    J = nonsym(dtype)
    b = np.ones(J.num_rows, dtype)
    out = solve(js.gmres, solvers.gmres, J, b, 500, 1e-8, restart=restart)
    agree(*out, dtype)
    if dtype == np.float64:
        assert out[3].converged() and resid(J, out[2], b) < 1e-6


@pytest.mark.parametrize("dtype", DTYPES)
def test_gmres_spd_with_precond(dtype):
    J = spd(15, dtype)
    b = np.ones(J.num_rows, dtype)
    out = solve(js.gmres, solvers.gmres, J, b, 400, 1e-8, restart=30,
                 M=diag_ops(J))
    agree(*out, dtype)
    assert out[3].converged()


@pytest.mark.parametrize("dtype", DTYPES)
def test_gmres_iteration_limit_mid_restart(dtype):
    """The monitor's limit stops GMRES inside a restart cycle."""
    J = nonsym(dtype, 100, seed=7)
    b = np.ones(100, dtype)
    out = solve(js.gmres, solvers.gmres, J, b, 7, 1e-12, restart=40)
    agree(*out, dtype)
    assert not out[3].converged() and out[3].iteration_count() == 7
