"""Restarted GMRES with Givens rotations (counterpart of
cusp_autotuned_tpu/solvers/gmres.py; parity target cusp::krylov::gmres,
cusp/krylov/detail/gmres.inl: left preconditioning, restart-R Arnoldi,
plane rotations, back-substitution).

As in the JAX package the Arnoldi step orthogonalises with two classical
Gram-Schmidt passes (CGS2), each a product of the basis V (up to R + 1
rows of n) with a vector, conjugated so that complex systems stay
orthogonal.  The Hessenberg matrix, the rotations and the triangular
solve stay on the device as small tensors.  The rotations are kept as one
accumulated unitary Q: a new Hessenberg column is rotated by Q (one small
product) and a new rotation updates two rows of Q, where the JAX package
applies the step's earlier rotations one after another; both compute the
same product of rotations.

The loop is cg.py's, within a restart cycle: the host reads the stop flag
once per block of CHECK_EVERY inner steps (every step with an M), and the
steps of a block after the stop are masked.  At the end of a cycle it
reads the number of steps that count and whether to go on, and solves the
triangular system of those steps.  The iteration limit can stop a solve
inside a cycle.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.ops import blas
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.solvers.cg import start
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor, MonitorState


def _rotation(dx, dy):
    """(c, s) of the rotation that zeroes dy against dx, complex-safe (the
    reference's GeneratePlaneRotation: c = |dx| / nrm, s = (dx / |dx|)
    conj(dy) / nrm, and c = 1, s = 0 where both are 0)."""
    adx = torch.abs(dx)
    denom = torch.sqrt(adx * adx + torch.abs(dy) ** 2)
    safe = torch.where(denom > 0, denom, 1)
    sgn = torch.where(adx > 0, dx / torch.where(adx > 0, adx, 1), 1)
    c = torch.where(denom > 0, adx / safe, 1).to(dx.dtype)
    s = torch.where(denom > 0, sgn * torch.conj(dy) / safe, 0).to(dx.dtype)
    return c, s


def _cycle(A, M, b, x, state: MonitorState, R: int, check_every: int):
    """One restart cycle from x: records the restart residual and up to R
    inner residual estimates in `state`, and returns the new x and whether
    the solve goes on."""
    n, dtype = b.shape[0], b.dtype
    r = M(b - multiply(A, x))
    beta = blas.nrm2(r)
    state.record_(beta)
    V = b.new_zeros((R + 1, n))
    V[0] = r / torch.where(beta > 0, beta, 1)
    H = b.new_zeros((R + 1, R))
    Q = torch.eye(R + 1, dtype=dtype, device=b.device)
    g = b.new_zeros(R + 1)
    g[0] = beta
    m_eff = torch.zeros((), dtype=torch.int64, device=b.device)   # steps taken
    steps = 0
    active = state.keep_going()
    while steps < R and bool(active):
        for i in range(steps, min(steps + check_every, R)):
            w = M(multiply(A, V[i]))
            basis = V[: i + 1]
            h1 = torch.mv(basis.conj(), w)
            w = w - h1 @ basis
            h2 = torch.mv(basis.conj(), w)
            w = w - h2 @ basis
            hnorm = blas.nrm2(w).to(dtype)
            breakdown = torch.abs(hnorm) <= 1e-30
            V[i + 1] = torch.where(active, w / torch.where(breakdown, 1, hnorm),
                                   V[i + 1])
            col = Q[: i + 2, : i + 2] @ torch.cat([h1 + h2, hnorm.view(1)])
            c, s = _rotation(col[i], col[i + 1])
            col[i] = c * col[i] + s * col[i + 1]
            col[i + 1] = 0
            H[: i + 2, i] = torch.where(active, col, H[: i + 2, i])
            q_i, q_next = Q[i], Q[i + 1]
            Q[i: i + 2] = torch.where(active, torch.stack(
                [c * q_i + s * q_next, -torch.conj(s) * q_i + c * q_next]),
                Q[i: i + 2])
            g_i = g[i]
            g[i: i + 2] = torch.where(active, torch.stack(
                [c * g_i, -torch.conj(s) * g_i]), g[i: i + 2])
            state.record_(torch.abs(g[i + 1]), active)
            m_eff = torch.where(active, i + 1, m_eff)
            active = torch.logical_and(active, torch.logical_and(
                state.keep_going(), torch.logical_not(breakdown)))
        steps = min(steps + check_every, R)
    # one read for the steps that count and whether to go on
    m, more = torch.stack([m_eff, state.keep_going().long()]).tolist()
    if m:
        y = torch.linalg.solve_triangular(H[:m, :m], g[:m, None], upper=True)
        x = x + y[:, 0] @ V[:m]
    return x, bool(more)


def gmres(A, b, x0=None, restart: int = 50, monitor: Monitor | None = None,
          M=None, mesh=None):
    """Solve A x = b with restarted GMRES(restart).  Returns (x, monitor);
    mesh as in cg.  The monitor records each cycle's restart residual (of
    M r, the left-preconditioned system) and each inner step's estimate."""
    A, b, x, monitor, M, check_every = start(A, b, x0, monitor, M, mesh)
    state = monitor.to_state(b)
    R = int(min(restart, max(1, monitor.iteration_limit())))
    more = True
    while more:
        x, more = _cycle(A, M, b, x, state, R, check_every)
    monitor.absorb_state(state)
    return x, monitor
