"""The Krylov solvers' edges, on the CPU: BiCGstab's exit in mid-iteration
and BiCG's exit on breakdown, each against the JAX package on the same
input, and for every unpreconditioned solver the stop flag read once per
block of iterations against a read every iteration."""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import solvers as js
from cusp_autotuned_tpu.backend.reference import from_scipy as jfrom_scipy

from cusp_autotuned_tpu_torch import gallery, solvers
from cusp_autotuned_tpu_torch.backend.reference import from_scipy

from tests.krylov_parity import agree, solve
from tests.torch_parity import one_thread  # noqa: F401

cg_module = importlib.import_module("cusp_autotuned_tpu_torch.solvers.cg")
CPU = torch.device("cpu")


@pytest.mark.parametrize("diagonal,its", [([2.0] * 8, 1),
                                          ([1.0] * 4 + [3.0] * 4, 2),
                                          ([1.0] * 3 + [2.0] * 3 + [4.0] * 3, 3)])
def test_bicgstab_exits_in_mid_iteration(diagonal, its):
    """s converges in the BiCG half of the last iteration: the solve stops
    there, as the JAX package's does.  On 2 I that is the first iteration,
    where omega = <AMs, s> / <AMs, AMs> is 0/0: its NaN must reach neither x
    nor the history."""
    J = jfrom_scipy(sp.diags(np.asarray(diagonal)).tocoo(), "csr")
    b = np.ones(J.num_rows)
    xj, mj, xp, mp = solve(js.bicgstab, solvers.bicgstab, J, b, 50, 1e-10)
    agree(xj, mj, xp, mp, np.float64)
    assert mp.iteration_count() == its and mp.converged()
    assert np.all(np.isfinite(mp.residuals))
    np.testing.assert_allclose(xp, 1.0 / np.asarray(diagonal), rtol=1e-12)


def test_bicg_exits_on_breakdown():
    """One step of BiCG on this A and b = 1 leaves r = (-2, 1, 1) and r* =
    (0, -2, 2): rho = <z, r*> is exactly 0 and the solve stops after that
    iteration, unconverged, as the JAX package's does."""
    S = sp.coo_matrix(np.array([[2.0, 0, 1], [0, 1, -1], [-1, 2, -1]]))
    J = jfrom_scipy(S, "csr")
    b = np.ones(3)
    xj, mj, xp, mp = solve(js.bicg, solvers.bicg, J, b, 50, 1e-10)
    agree(xj, mj, xp, mp, np.float64)
    assert mp.iteration_count() == 1 and not mp.converged()
    np.testing.assert_array_equal(xp, np.ones(3))


def _nonsym_port(n=300, seed=4):
    rng = np.random.RandomState(seed)
    S = sp.random(n, n, density=0.02, random_state=rng) + sp.diags(np.full(n, 4.0))
    return from_scipy(S.astype(np.float32), "csr", device=CPU)


SOLVES = {
    "cr": lambda A, N, b, mon: solvers.cr(A, b, monitor=mon),
    "bicg": lambda A, N, b, mon: solvers.bicg(N, b, monitor=mon),
    "bicgstab": lambda A, N, b, mon: solvers.bicgstab(N, b, monitor=mon),
    "gmres": lambda A, N, b, mon: solvers.gmres(N, b, restart=20, monitor=mon),
    "cg_m": lambda A, N, b, mon: solvers.cg_m(A, b, [0.0, 0.5], monitor=mon),
    "bicgstab_m": lambda A, N, b, mon: solvers.bicgstab_m(N, b, [0.0, 0.5],
                                                          monitor=mon),
}


@pytest.mark.parametrize("limit", [2000, 5])
@pytest.mark.parametrize("name", sorted(SOLVES))
def test_blocked_stop_check_equals_per_iteration(monkeypatch, name, limit):
    """Reading the stop flag once per block of CHECK_EVERY iterations, with
    the tail of the block masked, gives bit for bit the solve that reads it
    every iteration: converged (2000) and at the limit (5)."""
    A = gallery.poisson5pt(20, 20, format="dia", device="cpu")
    N = _nonsym_port()
    solve_ = SOLVES[name]
    b = torch.from_numpy(np.random.RandomState(0).rand(A.num_rows).astype(np.float32))
    if name in ("bicg", "bicgstab", "gmres", "bicgstab_m"):
        b = torch.from_numpy(np.random.RandomState(0).rand(N.num_rows).astype(np.float32))
    x_blk, m_blk = solve_(A, N, b, solvers.Monitor(b, limit, 1e-5))
    monkeypatch.setattr(cg_module, "CHECK_EVERY", 1)
    x_one, m_one = solve_(A, N, b, solvers.Monitor(b, limit, 1e-5))
    assert m_blk.iteration_count() == m_one.iteration_count()
    assert m_blk.converged() == (limit == 2000)
    assert m_blk.residuals == m_one.residuals
    assert torch.equal(x_blk, x_one)
