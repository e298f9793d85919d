"""BiCGstab (counterpart of cusp_autotuned_tpu/solvers/bicgstab.py; parity
target cusp::krylov::bicgstab, cusp/krylov/detail/bicgstab.inl, with its
exit in mid-iteration once s has converged).

The loop is cg.py's.  The JAX package branches on the early exit with a
lax.cond; here both halves are computed and torch.where picks one, so an
iteration costs the same either way and nothing is read back.  Where s
has converged, omega = <AMs, s> / <AMs, AMs> may be 0/0: the values of the
full half are then dropped by torch.where and reach neither x, r, p, rrs
nor the history, and the solve stops after that iteration.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.ops import blas
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.solvers.cg import start
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor


def bicgstab(A, b, x0=None, monitor: Monitor | None = None, M=None,
             mesh=None):
    """Solve A x = b.  Returns (x, monitor); mesh as in cg."""
    A, b, x, monitor, M, check_every = start(A, b, x0, monitor, M, mesh)
    state = monitor.to_state(b)
    r = b - multiply(A, x)
    state.record_(blas.nrm2(r))
    r_star = r
    p = r
    rrs = blas.dotc(r_star, r)
    active = state.keep_going()
    while bool(active):
        for _ in range(check_every):
            Mp = M(p)
            AMp = multiply(A, Mp)
            alpha = rrs / blas.dotc(r_star, AMp)
            s = torch.addcmul(r, alpha, AMp, value=-1)
            s_norm = blas.nrm2(s)
            early = s_norm <= state.tolerance
            Ms = M(s)
            AMs = multiply(A, Ms)
            omega = blas.dotc(AMs, s) / blas.dotc(AMs, AMs)
            x_early = torch.addcmul(x, alpha, Mp)
            r_full = torch.addcmul(s, omega, AMs, value=-1)
            rrs_new = blas.dotc(r_star, r_full)
            beta = (rrs_new / rrs) * (alpha / omega)
            full = torch.logical_and(active, torch.logical_not(early))
            x = torch.where(active, torch.where(
                early, x_early, torch.addcmul(x_early, omega, Ms)), x)
            r = torch.where(active, torch.where(early, s, r_full), r)
            p = torch.where(full, torch.addcmul(
                r_full, beta, torch.addcmul(p, omega, AMp, value=-1)), p)
            rrs = torch.where(full, rrs_new, rrs)
            state.record_(torch.where(early, s_norm, blas.nrm2(r_full)), active)
            active = torch.logical_and(full, state.keep_going())
    monitor.absorb_state(state)
    return x, monitor
