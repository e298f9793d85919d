"""BiCG (counterpart of cusp_autotuned_tpu/solvers/bicg.py; parity target
cusp::krylov::bicg, cusp/krylov/detail/bicg.inl: the dual recurrence on
(r, r*) with A, A^T, M and M^T, and an exit on breakdown, rho == 0).

A^T and M^T are built once at set-up (ops.transpose) unless the caller
passes them; on a CUDA device A^T and a sparse M^T are planned like A and
M, so their products run the same kernels.  The loop is cg.py's; the
breakdown ends the solve after the iteration that found it, which the
monitor has recorded, as in the JAX package.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.operators import (
    IdentityOperator, as_operator, solve_operator,
)
from cusp_autotuned_tpu_torch.ops import blas
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.ops.transpose import transpose
from cusp_autotuned_tpu_torch.solvers.cg import start
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor


def bicg(A, b, x0=None, monitor: Monitor | None = None, M=None,
         At=None, Mt=None, mesh=None):
    """Solve A x = b.  Returns (x, monitor).  At and Mt default to the
    transposes of A and M (an operator A has none: pass At).  mesh: A and
    A^T are both row-sharded over it, b and x0 go to its home device."""
    if At is None:
        At = transpose(A)
    if Mt is None and M is not None and not isinstance(M, IdentityOperator):
        Mt = transpose(M)
    if mesh is not None:
        from cusp_autotuned_tpu_torch.parallel.sharded import distribute_for_solve
        At, = distribute_for_solve(At, mesh)
    At = solve_operator(At)
    A, b, x, monitor, M, check_every = start(A, b, x0, monitor, M, mesh)
    Mt = M if Mt is None else as_operator(solve_operator(Mt))
    state = monitor.to_state(b)
    r = b - multiply(A, x)
    state.record_(blas.nrm2(r))
    r_star = r
    z = M(r)
    z_star = Mt(r_star)
    rho = blas.dotc(z, r_star)
    p = z
    p_star = z_star
    active = state.keep_going()
    while bool(active):
        for _ in range(check_every):
            q = multiply(A, p)
            q_star = multiply(At, p_star)
            alpha = torch.where(active, rho / blas.dotc(p_star, q), 0)
            x = torch.addcmul(x, alpha, p)
            r = torch.addcmul(r, alpha, q, value=-1)
            r_star = torch.addcmul(r_star, alpha, q_star, value=-1)
            state.record_(blas.nrm2(r), active)
            z = M(r)
            z_star = Mt(r_star)
            rho_new = blas.dotc(z, r_star)
            ratio = rho_new / rho
            p = torch.where(active, torch.addcmul(z, ratio, p), p)
            p_star = torch.where(active, torch.addcmul(z_star, ratio, p_star), p_star)
            rho = torch.where(active, rho_new, rho)
            active = torch.logical_and(active, torch.logical_and(
                rho_new != 0, state.keep_going()))
    monitor.absorb_state(state)
    return x, monitor
