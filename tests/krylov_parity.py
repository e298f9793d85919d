"""Helpers for the parity tests of the Krylov solvers: one call on each
package (the JAX package and its port) on the same seeded numpy inputs,
and the agreement the tests hold them to.

In f64 the iteration counts are equal and x and the residual history agree
to rtol 1e-8.  In f32 x agrees to rtol 1e-4 and the counts are equal or
one apart: tests/test_krylov.py's cases ask for tolerances of 1e-8 and
1e-9, below what an f32 residual resolves, so their last iterations compare
rounding noise, and the two packages round differently (XLA's sum order
against torch's)."""

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery, solvers as js
from cusp_autotuned_tpu.backend.reference import from_scipy as jfrom_scipy
from cusp_autotuned_tpu.operators import make_linear_operator as jlinear

from cusp_autotuned_tpu_torch.operators import make_linear_operator
from cusp_autotuned_tpu_torch.solvers import Monitor

from tests.torch_parity import port_of

DTYPES = [np.float64, np.float32]


def spd(n, dtype):
    return jgallery.poisson5pt(n, n, format="csr", dtype=dtype)


def nonsym(dtype, n=200, seed=2):
    """tests/test_krylov.py's recipe: 3 % random entries plus 6 I."""
    rng = np.random.RandomState(seed)
    S = sp.random(n, n, density=0.03, random_state=rng, dtype=np.float64)
    S = S + sp.diags(np.full(n, 6.0))
    return jfrom_scipy(S.astype(dtype).tocoo(), "csr")


def solve(jfn, pfn, J, b, limit, rtol, *args, M=None, **kw):
    """(x_jax, monitor_jax, x_port, monitor_port) of one call on each
    package; M is a pair (JAX operator, port operator)."""
    bj, bp = jnp.asarray(b), torch.from_numpy(b)
    mj = {} if M is None else {"M": M[0]}
    mp = {} if M is None else {"M": M[1]}
    xj, monj = jfn(J, bj, *args, monitor=js.Monitor(bj, limit, rtol), **mj, **kw)
    xp, monp = pfn(port_of(J), bp, *args, monitor=Monitor(bp, limit, rtol), **mp, **kw)
    return np.asarray(xj), monj, xp.numpy(), monp


def agree(xj, monj, xp, monp, dtype):
    """f64: equal counts, x and history to rtol 1e-8; f32: counts at most
    one apart (see the module docstring), x to rtol 1e-4."""
    ij, ip = monj.iteration_count(), monp.iteration_count()
    scale = np.abs(xj).max()
    if dtype == np.float32 or dtype == np.complex64:
        assert abs(ij - ip) <= 1, (ij, ip)
        np.testing.assert_allclose(xp, xj, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert ij == ip
        # a residual at f64's rounding level (an exact solve) compares to
        # 1e-14 of the first
        np.testing.assert_allclose(monp.residuals, monj.residuals, rtol=1e-8,
                                   atol=1e-14 * monj.residuals[0])
        np.testing.assert_allclose(xp, xj, rtol=1e-8, atol=1e-8 * scale)
    assert monp.converged() == monj.converged()
    assert np.all(np.isfinite(xp))


def resid(J, x, b):
    S = J.to_scipy().astype(np.float64)
    return np.linalg.norm(b - S @ x) / np.linalg.norm(b)


def diag_ops(J):
    """The diagonal preconditioner r / diag(A) on both packages."""
    d = np.asarray(J.to_scipy().diagonal())
    dj, dp = jnp.asarray(d), torch.from_numpy(d)
    return jlinear(lambda r: r / dj), make_linear_operator(lambda r: r / dp)
