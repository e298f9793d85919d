"""Conjugate residual (counterpart of cusp_autotuned_tpu/solvers/cr.py;
parity target cusp::krylov::cr, cusp/krylov/detail/cr.inl, with its
recomputation of the true residual b - A x every RECOMPUTE_R iterations).

The loop is cg.py's: the host reads the stop flag once per block of
CHECK_EVERY iterations (every iteration with an M), and the iterations of
a block after the stop are masked.  Which iterations recompute r is known
on the host: it counts the iterations it runs, and that count equals the
monitor's for every iteration that is not masked.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.ops import blas
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.solvers.cg import start
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor

RECOMPUTE_R = 8


def cr(A, b, x0=None, monitor: Monitor | None = None, M=None, mesh=None):
    """Solve A x = b for a Hermitian A.  Returns (x, monitor); mesh as in
    cg."""
    A, b, x, monitor, M, check_every = start(A, b, x0, monitor, M, mesh)
    state = monitor.to_state(b)
    r = b - multiply(A, x)
    state.record_(blas.nrm2(r))
    z = M(r)
    p = z
    y = multiply(A, p)
    rz = blas.dotc(r, multiply(A, z))
    active = state.keep_going()
    k = 0                                   # the iterations run so far
    while bool(active):
        for _ in range(check_every):
            alpha = torch.where(active, rz / blas.dotc(y, y), 0)
            x = torch.addcmul(x, alpha, p)
            if k % RECOMPUTE_R != 0:
                r = torch.addcmul(r, alpha, y, value=-1)
            else:
                r = torch.where(active, b - multiply(A, x), r)
            k += 1
            z = M(r)
            Az = multiply(A, z)
            rz_new = blas.dotc(r, Az)
            beta = rz_new / rz
            p = torch.where(active, torch.addcmul(z, beta, p), p)
            y = torch.where(active, torch.addcmul(Az, beta, y), y)
            rz = torch.where(active, rz_new, rz)
            state.record_(blas.nrm2(r), active)
            active = torch.logical_and(active, state.keep_going())
    monitor.absorb_state(state)
    return x, monitor
